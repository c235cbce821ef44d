"""Interval math: logical .dat ranges -> (shard id, offset in shard file).

A copy of the JAX package's ec/locate.py, itself a faithful
reimplementation of reference ec_locate.go:11-83. The .dat is striped
row-major: nLargeRows rows of 10 x largeBlock first, then rows of
10 x smallBlock covering the tail; shard file i holds its block of every
row, large rows first.

Deliberate divergence from the reference: its row-count formulas
(`datSize/(10*large)` in locateOffset, the `+10*small` fudge for
LargeBlockRowsCount) disagree with its own encoder for dat sizes within
10*smallBlock of a large-row boundary — the encoder's strict
`remaining > largeRow` loop emits the boundary row as small blocks, but
locate addresses it as a large row, misreading shard bytes (a ~10MB blind
window per 10GB at production geometry). Here the large-row count is
derived exactly as the encoder does — n_large(dat) = (dat-1) // (10*large)
— so locate and layout can never disagree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from .constants import DATA_SHARDS


@dataclass(frozen=True)
class Interval:
    block_index: int
    inner_block_offset: int
    size: int
    is_large_block: bool
    large_block_rows_count: int

    def to_shard_id_and_offset(self, large_block: int, small_block: int):
        offset = self.inner_block_offset
        row = self.block_index // DATA_SHARDS
        if self.is_large_block:
            offset += row * large_block
        else:
            offset += (self.large_block_rows_count * large_block
                       + row * small_block)
        return self.block_index % DATA_SHARDS, offset


def n_large_rows_for(dat_size: int, large_block: int) -> int:
    """Number of large rows the encoder actually wrote: one per full
    10*large_block row while STRICTLY more than a row remains."""
    if dat_size <= 0:
        return 0
    return (dat_size - 1) // (large_block * DATA_SHARDS)


def _locate_offset(large_block: int, small_block: int, dat_size: int,
                   offset: int):
    large_row = large_block * DATA_SHARDS
    n_large_rows = n_large_rows_for(dat_size, large_block)
    if offset < n_large_rows * large_row:
        return offset // large_block, True, offset % large_block
    offset -= n_large_rows * large_row
    return offset // small_block, False, offset % small_block


def locate_data(large_block: int, small_block: int, dat_size: int,
                offset: int, size: int) -> List[Interval]:
    block_index, is_large, inner = _locate_offset(
        large_block, small_block, dat_size, offset)
    n_large_rows = n_large_rows_for(dat_size, large_block)

    intervals: List[Interval] = []
    while size > 0:
        block_remaining = (large_block if is_large else small_block) - inner
        take = min(size, block_remaining)
        intervals.append(Interval(block_index, inner, take, is_large,
                                  n_large_rows))
        size -= take
        if size <= 0:
            break
        block_index += 1
        if is_large and block_index == n_large_rows * DATA_SHARDS:
            is_large = False
            block_index = 0
        inner = 0
    return intervals
