"""ShardBits — the bitmask of the shard ids one server holds of one EC
volume, as heartbeats carry it and the master's topology keeps it. The
JAX package's ``ec/shard_bits.py``."""

from __future__ import annotations

from .constants import DATA_SHARDS, TOTAL_SHARDS


class ShardBits(int):
    def add_shard_id(self, sid: int) -> "ShardBits":
        return ShardBits(self | (1 << sid))

    def remove_shard_id(self, sid: int) -> "ShardBits":
        return ShardBits(self & ~(1 << sid))

    def has_shard_id(self, sid: int) -> bool:
        return bool(self & (1 << sid))

    def shard_ids(self):
        return [i for i in range(TOTAL_SHARDS) if self.has_shard_id(i)]

    def shard_id_count(self) -> int:
        return bin(self).count("1")

    def plus(self, other: "ShardBits") -> "ShardBits":
        return ShardBits(self | other)

    def minus(self, other: "ShardBits") -> "ShardBits":
        return ShardBits(self & ~other)

    def minus_parity_shards(self) -> "ShardBits":
        out = self
        for sid in range(DATA_SHARDS, TOTAL_SHARDS):
            out = out.remove_shard_id(sid)
        return out
