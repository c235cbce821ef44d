"""filer — the metadata layer: path → entry (attributes and an ordered
chunk list) over a pluggable store (``memory``, ``sqlite``,
``sharded``), the chunked upload and read path, the metadata event log,
and the remote ``FilerClient``; and the etcd wire client
(``etcd_store``) that the master's ``EtcdSequencer`` uses. The redis,
mysql, postgres, cassandra and etcd filer stores are not ported."""
