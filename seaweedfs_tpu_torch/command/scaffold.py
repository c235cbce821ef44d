"""``weed-tpu scaffold``: commented example configs.

The JAX package's ``command/scaffold.py``, string for string, so that a
file printed by either package configures both: ``print_scaffold(name)``
for ``tier``, ``s3``, ``replication``, ``security``, ``notification``,
``filer`` and ``master``. ``security`` and ``master`` are read by the
port's CLI (``util/config.load_config``); the others name flags and
modules of their own (the replication and notification modules are not
ported yet: their templates are examples only).
"""

SCAFFOLDS = {
    "tier": """\
// volume/server -tierConfig: remote backends for volume.tier.upload
// (reference master.toml [storage.backend.<kind>.<id>])
{
  "s3": {
    "default": {
      "endpoint": "http://s3.example.com:8333",
      "bucket": "volume-tier",
      "access_key": "ACCESSKEY",
      "secret_key": "SECRETKEY",
      "region": "us-east-1"
    }
  },
  "dir": {
    "cold": {"path": "/mnt/cold-disk/tier"}
  }
}
""",
    "s3": """\
// s3 / filer -s3Config: IAM identities and per-identity actions
// (reference s3 config shape, weed/s3api/auth_credentials.go)
{
  "identities": [
    {
      "name": "admin",
      "credentials": [
        {"accessKey": "ACCESSKEY", "secretKey": "SECRETKEY"}
      ],
      "actions": ["Admin", "Read", "Write", "List", "Tagging"]
    },
    {
      "name": "readonly",
      "credentials": [
        {"accessKey": "ROKEY", "secretKey": "ROSECRET"}
      ],
      "actions": ["Read", "List"]
    }
  ]
}
""",
    "replication": """\
// filer.replicate -config: follow one filer's events into a sink
// (reference replication.toml [source.filer] + [sink.*])
{
  "source": {
    "filer": "127.0.0.1:8888",
    "master": "127.0.0.1:9333",
    "path": "/buckets"
  },
// sink alternatives: "type": "filer" (below); "type": "s3" with
// endpoint/bucket/access_key/secret_key/directory; "gcs"/"b2" (same
// keys over their S3-interop APIs); "azure" with
// account/account_key/container/directory (SharedKey Blob REST)
  "sink": {
    "type": "filer",
    "filer_url": "remote-filer:8888",
    "target_dir": "/backup"
  }
}
""",
    "security": """\
// security.toml — searched in ., ~/.seaweedfs_tpu, /etc/seaweedfs_tpu
// (reference util/config.go tiers); every key also overridable via
// WEED_* env vars, e.g. WEED_JWT_SIGNING_KEY=secret.
// Equivalent flags: -jwtKey, -tlsCert/-tlsKey/-tlsCa, -whiteList.
//
//   [jwt.signing]
//   key = "write-token-secret"      # JWT-protected writes
//
//   [https]                         # TLS on every surface
//   cert = "/etc/seaweedfs_tpu/cluster.crt"
//   key  = "/etc/seaweedfs_tpu/cluster.key"
//   ca   = "/etc/seaweedfs_tpu/ca.crt"
{}
""",
    "notification": """\
// filer notification publisher (reference notification.toml):
// configured programmatically via
// seaweedfs_tpu.notification.make_publisher(name, **options);
// built-ins:
//   "log"      print events
//   "memory"   in-process pub-sub (tests/replicator)
//   "webhook"  POST JSON to any HTTP endpoint, options:
//              url, timeout, retries, hmac_key (X-Seaweed-Signature)
//   "kafka"    classic-protocol producer (no SDK), options:
//              hosts ("h1:9092,h2:9092"), topic, timeout, retries
//   "aws_sqs"  SendMessage via the SQS query API (SigV4), options:
//              queue_url, access_key, secret_key, region
//   "google_pub_sub"  REST publish with OAuth2 JWT-bearer auth
//              (no SDK), options: google_application_credentials
//              (service-account json), project_id, topic,
//              endpoint/token_uri overrides for emulators
//   "gocdk_pub_sub"  URL-dispatching meta-publisher: one topic_url
//              whose scheme picks the broker (kafka://topic,
//              awssqs://sqs.<region>.amazonaws.com/<acct>/<queue>,
//              gcppubsub://projects/<p>/topics/<t>, mem://,
//              http(s):// webhook); remaining options pass through
{}
""",
    "filer": """\
// filer store selection (reference filer.toml):
//   -store memory                     volatile, tests
//   -store sqlite  -db ./filer.db     single-file embedded store
//   -store sharded -db ./filer_meta \\
//          -storeShards 8             leveldb2-style sharded store:
//                                     md5(dir) routes to one of N
//                                     sqlite shards; count is sticky
//   -store redis   -redisAddr host:6379 [-redisPassword ..]
//          [-redisDb N]               external store over a built-in
//                                     RESP client (Redis/KeyDB/Valkey)
//   -store mysql   -mysqlAddr host:3306 -mysqlUser .. -mysqlPassword ..
//          [-mysqlDatabase seaweedfs]  built-in MySQL wire client
//                                      (MySQL/MariaDB/Percona/Vitess)
//   -store postgres -postgresAddr host:5432 -postgresUser ..
//          -postgresPassword .. [-postgresDatabase seaweedfs]
//                                      built-in protocol-3.0 client
//                                      with SCRAM-SHA-256 auth
//   -store cassandra -cassandraAddr host:9042 [-cassandraUser ..
//          -cassandraPassword ..] [-cassandraKeyspace seaweedfs]
//                                      built-in CQL v4 client
//                                      (directory-partitioned table)
//   -store etcd -etcdAddr host:2379 [-etcdUser .. -etcdPassword ..]
//                                      built-in etcd v3 JSON-gateway
//                                      client (bearer auth, prefix
//                                      ranges over <dir>\\0<name> keys)
{}
""",
    "master": """\
# master.toml — searched in ., ~/.seaweedfs_tpu, /etc/seaweedfs_tpu
# (reference scaffold.go MASTER_TOML_EXAMPLE); keys also overridable
# via WEED_MASTER_* env vars. Flags win over config when both are set.

[master.maintenance]
# shell command lines cron'd on the leader, one per line
# (equivalent flag: -maintenanceScripts, ';'-separated)
scripts = \"\"\"
  ec.rebuild
  volume.balance
  volume.vacuum -garbageThreshold 0.3
\"\"\"
sleep_minutes = 17            # -maintenanceIntervalSeconds / 60

[master.filer]
# filer the maintenance shell's fs.* commands talk to
default_filer_url = "http://localhost:8888/"

[master.sequencer]
type = "memory"               # memory | etcd  (-sequencer)
# first URL is used; plain host:port works too  (-sequencerEtcd)
sequencer_etcd_urls = "http://127.0.0.1:2379"

# tier destinations for volume.tier.upload (same shape as the
# reference master.toml [storage.backend]; also via -tierConfig JSON)
[storage.backend.s3.default]
enabled = false
aws_access_key_id = ""
aws_secret_access_key = ""
region = "us-east-1"
bucket = "volume-tier"
endpoint = "http://s3.example.com:8333"

# volumes grown per growth event, by replica copy count
# (reference master.toml [master.volume_growth])
[master.volume_growth]
copy_1 = 7
copy_2 = 6
copy_3 = 3
copy_other = 1
""",
}


def print_scaffold(name: str) -> str:
    if name not in SCAFFOLDS:
        raise SystemExit(
            f"unknown config {name!r}; have {sorted(SCAFFOLDS)}")
    return SCAFFOLDS[name]
