"""EC geometry constants (reference ec_encoder.go:17-23)."""

DATA_SHARDS = 10
PARITY_SHARDS = 4
TOTAL_SHARDS = 14

LARGE_BLOCK_SIZE = 1024 * 1024 * 1024  # 1GB
SMALL_BLOCK_SIZE = 1024 * 1024         # 1MB


def to_ext(shard_id: int) -> str:
    return f".ec{shard_id:02d}"
