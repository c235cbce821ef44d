"""filer — so far only the etcd wire client (``etcd_store``), which the
master's ``EtcdSequencer`` uses; the filer and its stores are not
ported."""
