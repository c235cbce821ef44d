"""filer — the metadata layer: path → entry (attributes and an ordered
chunk list) over a pluggable store (``memory``, ``sqlite``,
``sharded``, and the network stores ``redis``, ``mysql``, ``postgres``,
``cassandra`` and ``etcd``), the chunked upload and read path, the
metadata event log, and the remote ``FilerClient``; ``etcd_store``'s
wire client also serves the master's ``EtcdSequencer``."""
