"""Host-built tile plan for the GF(2^8) product kernel (csrc/gf_matmul.cu).

The kernel computes out (r, n) = coeffs (r, k) x data (k, n) over GF(2^8)
four output rows at a time, and it only visits the (tile, input row) pairs
whose coefficients are not all zero. The plan says which pairs those are
and carries their tables, built once per matrix in numpy:

* **row order**: output rows stably sorted by their non-zero pattern, then
  cut into tiles of 4 (``TILE_ROWS``), so rows with one support share a
  tile. ``row_map[p]`` is the output row in sorted slot p; the last tile
  holds ``last_rows`` real rows.
* **pairs**: for tile t, ``pair_rows[tile_ptr[t]:tile_ptr[t+1]]`` lists,
  ascending, every input row with a non-zero coefficient in the tile. A
  tile whose list is empty writes zeros.
* **tables**: 32 words per pair. Word x < 16 packs the products of x with
  the tile's 4 coefficients, slot i in byte i; word 16 + x packs the
  products of x << 4. One lookup of each nibble of a payload byte gives
  its products with all 4 rows, c*b = lo[b & 15] ^ hi[b >> 4] (missing
  tail rows are zero bytes).

The piggyback RS(10,4) encode matrix (128, 320) has 15 non-zeros in every
row and the 4 parities of one sub-stripe share them, so its plan has 480
pairs (the payload read 1.5 times over) where a dense walk does 40,960
lookups per column; its tables take 61 KB.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .device_stats import PLAN_ENTRY, coeff_key, timed_build
from .gf256 import MUL_TABLE

TILE_ROWS = 4     # output rows per tile: one packed uint32 per column
TABLE_WORDS = 32  # 16 low-nibble + 16 high-nibble words per pair


@dataclass(frozen=True, eq=False)
class GfPlan:
    """The kernel's constant for one coefficient matrix. Every tensor lies
    on one device; ``to`` moves them together."""

    coeffs: torch.Tensor     # (r, k) uint8, the matrix (the plain version's)
    row_map: torch.Tensor    # (r,) int32: sorted slot -> output row
    tile_ptr: torch.Tensor   # (tiles + 1,) int32: pair offsets per tile
    pair_rows: torch.Tensor  # (pairs,) int32: input row of each pair
    tables: torch.Tensor     # (pairs, 32) int32: packed words (uint32 bits)

    def __post_init__(self):
        """Checked once here, so a launch need not: the kernel reads the
        four int32 tensors through raw pointers."""
        if self.coeffs.dtype != torch.uint8 or self.coeffs.dim() != 2:
            raise ValueError(f"coeffs must be a 2-D uint8 tensor, got "
                             f"{self.coeffs.dtype} {tuple(self.coeffs.shape)}")
        for t in (self.row_map, self.tile_ptr, self.pair_rows, self.tables):
            if t.dtype != torch.int32 or t.device != self.coeffs.device or \
                    not t.is_contiguous():
                raise ValueError("plan tensors must be contiguous int32 on "
                                 f"{self.coeffs.device}, got {t.dtype} on "
                                 f"{t.device}")

    @property
    def r(self) -> int:
        return self.coeffs.shape[0]

    @property
    def k(self) -> int:
        return self.coeffs.shape[1]

    @property
    def tiles(self) -> int:
        return self.tile_ptr.shape[0] - 1

    @property
    def pairs(self) -> int:
        """(tile, input row) pairs: payload rows read per column."""
        return self.pair_rows.shape[0]

    @property
    def last_rows(self) -> int:
        """Real rows in the last tile (the others are zero slots)."""
        return self.r - TILE_ROWS * (self.tiles - 1) if self.tiles else 0

    @property
    def table_bytes(self) -> int:
        return self.tables.numel() * 4

    @property
    def device(self) -> torch.device:
        return self.coeffs.device

    def to(self, device) -> "GfPlan":
        return GfPlan(*(t.to(device) for t in (
            self.coeffs, self.row_map, self.tile_ptr, self.pair_rows,
            self.tables)))

    def summary(self) -> dict:
        """Pairs per column, table bytes, and how many times over the
        kernel reads the payload (pairs / k)."""
        return {"shape": [self.r, self.k], "tiles": self.tiles,
                "pairs_per_column": self.pairs,
                "table_bytes": self.table_bytes,
                "payload_reads": self.pairs / self.k if self.k else 0.0}


def make_plan(coeffs, owner=None) -> GfPlan:
    """The tile plan of an (r, k) GF(2^8) coefficient matrix (numpy or a
    CPU tensor), on the CPU. Each build is a compile in
    ``ops/device_stats``; ``owner`` (a codec's constant cache) holds one
    plan per matrix, so its second build of one matrix is a recompile."""
    if isinstance(coeffs, torch.Tensor):
        coeffs = coeffs.cpu().numpy()
    coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)
    if coeffs.ndim != 2:
        raise ValueError(f"coeffs must be 2-D, got shape {coeffs.shape}")
    return timed_build(PLAN_ENTRY, coeff_key(coeffs),
                       lambda: _build(coeffs), owner)


def _build(coeffs: np.ndarray) -> GfPlan:
    r, k = coeffs.shape
    nz = coeffs != 0
    # stable: rows with equal patterns keep their order
    row_map = np.asarray(sorted(range(r), key=lambda i: nz[i].tobytes()),
                         dtype=np.int32)
    tiles = -(-r // TILE_ROWS)
    blocks = np.zeros((tiles * TILE_ROWS, k), dtype=np.uint8)
    blocks[:r] = coeffs[row_map]
    blocks = blocks.reshape(tiles, TILE_ROWS, k)
    used = blocks.any(axis=1)                      # (tiles, k)
    tile_ptr = np.zeros(tiles + 1, dtype=np.int32)
    tile_ptr[1:] = np.cumsum(used.sum(axis=1))
    pair_tile, pair_rows = np.nonzero(used)        # tile-major, rows ascending
    c = blocks[pair_tile, :, pair_rows]            # (pairs, 4)
    x = np.arange(16, dtype=np.uint8)
    shift = (8 * np.arange(TILE_ROWS, dtype=np.uint32))[None, :, None]

    def packed(values):                            # (pairs, 16) uint32
        prod = MUL_TABLE[c[:, :, None], values[None, None, :]]
        return np.bitwise_or.reduce(prod.astype(np.uint32) << shift, axis=1)

    tables = np.concatenate([packed(x), packed(x << 4)], axis=1)
    tables = np.ascontiguousarray(tables.reshape(-1, TABLE_WORDS),
                                  dtype=np.uint32)
    return GfPlan(coeffs=torch.from_numpy(coeffs),
                  row_map=torch.from_numpy(row_map),
                  tile_ptr=torch.from_numpy(tile_ptr),
                  pair_rows=torch.from_numpy(pair_rows.astype(np.int32)),
                  tables=torch.from_numpy(tables.view(np.int32)))
