"""server — the HTTP layer of the port: the pooled client the remote
shard readers call, and the EC holder routes of a volume server."""
