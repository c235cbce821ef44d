"""Reed-Solomon codec API + backend registry.

Semantics mirror the reference dependency's Encode/Reconstruct
(klauspost/reedsolomon): shards are equal-length byte rows, data rows
are stored verbatim (systematic code), missing shards are None and are
regenerated in place.

Backends:
    get_codec(k, m, backend="cuda" | "mesh" | "numpy", device=..., mesh=...)
"cuda" is the hand-written Hopper kernel behind ops/rs_torch.TorchCodec
(its plain PyTorch version when the caller asks for device="cpu");
"mesh" is parallel/mesh_codec.MeshCodec, the same kernel at every
position of a mesh; "numpy" is the conformance oracle. There is no automatic choice: a
missing card raises instead of quietly running on the CPU. All
backends produce bit-identical output.

The host/device crossover of a device codec (``dispatch_threshold``) is
its ``small_dispatch_bytes`` unless the small-dispatch tuner
(``stats/metrics.SmallDispatchTuner``, fed by ``reconstruct`` spans) has
installed a live override, which it does when ``SMALL_DISPATCH_AUTO`` is
on; both are widths, bytes a survivor row.

Also here, host-side numpy like the rest of the GF(2^8) planning: the
trace-repair plans of a single lost shard (repair_plan, with the holder's
project_slab and the rebuilder's combine_planes_to_bytes), and the
piggybacked sub-chunk layout's plans (piggyback_plan,
piggyback_decode_plan, piggyback_repair_plan) with its window transforms
(pb_split / pb_merge, pb_plane_slice / pb_plane_rows).
"""

from __future__ import annotations

import itertools
import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..util import tracing
from . import device_stats, gf256
from .telemetry import STATS

#: Width (bytes) below which device codecs answer reconstruct() on the
#: host: a kilobyte needle range costs less as a LUT walk than as a
#: device round-trip.
SMALL_DISPATCH_BYTES = 256 << 10
#: SW_EC_SMALL_DISPATCH_AUTO: install the tuner's fitted crossover
#: (``stats/metrics.SmallDispatchTuner``) as the live threshold.
SMALL_DISPATCH_AUTO = False

# the live crossover the tuner installed; None: each codec's own
_SMALL_DISPATCH_OVERRIDE: Optional[int] = None


def small_dispatch_override() -> Optional[int]:
    return _SMALL_DISPATCH_OVERRIDE


def set_small_dispatch_override(nbytes: Optional[int]):
    """Install (or clear, with None or 0) the live crossover width."""
    global _SMALL_DISPATCH_OVERRIDE
    _SMALL_DISPATCH_OVERRIDE = int(nbytes) if nbytes else None


def maybe_auto_apply_small_dispatch(suggestion: int) -> bool:
    """Install the tuner's suggested crossover when
    ``SMALL_DISPATCH_AUTO`` is on; whether it was installed."""
    if not SMALL_DISPATCH_AUTO:
        return False
    set_small_dispatch_override(suggestion)
    return True


def host_matmul(coeffs: np.ndarray, data: np.ndarray) -> np.ndarray:
    """The pure-numpy GF(2^8) matmul: one 256-entry LUT gather + XOR per
    (output row, input row) pair. The conformance oracle, and the
    small-payload path device codecs delegate kilobyte reads to."""
    coeffs = np.asarray(coeffs, dtype=np.uint8)
    data = np.asarray(data, dtype=np.uint8)
    r = coeffs.shape[0]
    out = np.zeros((r, data.shape[1]), dtype=np.uint8)
    mt = gf256.MUL_TABLE
    for i in range(r):
        acc = out[i]
        for j in range(coeffs.shape[1]):
            c = coeffs[i, j]
            if c == 0:
                continue
            if c == 1:
                acc ^= data[j]
            else:
                acc ^= mt[c][data[j]]
    return out


def width_bucket(n: int, cap: int) -> int:
    """Pad widths up to power-of-two buckets (at least 512, capped) so
    varied payload widths reuse the same launch geometry and buffers."""
    return min(max(512, 1 << (n - 1).bit_length()), cap)


class _ConstCache:
    """Bounded LRU of device-resident coefficient constants, keyed by
    the coefficient bytes. A rebuild uploads its constant once, not once
    per slab — every make() call counts as a bitmat_upload in
    ops/telemetry, so a run can assert exactly that. Hits, misses and
    evictions go to ``ops/device_stats``, and the cache registers there
    (weakly) so its entries and their tensor bytes can be read. Its
    ``owner`` serial names it to ``gf_plan.make_plan``, so that a plan it
    builds a second time for one key is seen as a recompile."""

    _serial = itertools.count(1)

    def __init__(self, maxsize: int = 32):
        self._entries: OrderedDict = OrderedDict()
        self._maxsize = maxsize
        self._lock = threading.Lock()
        self.owner = next(self._serial)
        self._stats = device_stats.DEVICE_STATS
        self._stats.register_const_cache(self)

    def get(self, key, make):
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
        if hit is not None:
            self._stats.note_const_cache("hits")
            return hit
        self._stats.note_const_cache("misses")
        val = make()
        STATS.add("bitmat_uploads")
        with self._lock:
            self._entries[key] = val
            evicted = len(self._entries) > self._maxsize
            if evicted:
                self._entries.popitem(last=False)
        if evicted:
            self._stats.note_const_cache("evictions")
        return val

    def occupancy(self) -> Dict[str, int]:
        """Entries held, and the bytes of the tensors they hold."""
        with self._lock:
            values = list(self._entries.values())
        return {"entries": len(values),
                "bytes": sum(_tensor_bytes(v) for v in values)}


def _tensor_bytes(value) -> int:
    """Bytes of the tensors in a cached constant (a plan, a tuple of
    them, a dataclass of tensors)."""
    if hasattr(value, "element_size") and hasattr(value, "numel"):
        return value.element_size() * value.numel()
    if isinstance(value, (tuple, list)):
        return sum(_tensor_bytes(v) for v in value)
    fields = getattr(value, "__dataclass_fields__", None)
    if fields:
        return sum(_tensor_bytes(getattr(value, f)) for f in fields)
    return 0


class ReedSolomonCodec:
    """Base class: matrix construction + reconstruction planning.

    Subclasses implement _matmul(coeffs, data) — the GF(2^8) matrix
    product over byte rows — which is the only compute-heavy primitive.
    Device-backed subclasses additionally expose device_fn() so
    ops/pipeline.PipelinedMatmul can stream slabs through their kernel.
    """

    backend = "abstract"
    # 0 = never delegate; device codecs override with SMALL_DISPATCH_BYTES
    small_dispatch_bytes = 0

    def __init__(self, data_shards: int, parity_shards: int,
                 matrix_kind: str = "vandermonde",
                 matrix: Optional[np.ndarray] = None):
        if data_shards <= 0 or parity_shards <= 0:
            raise ValueError("data_shards and parity_shards must be > 0")
        if data_shards + parity_shards > 256:
            raise ValueError("k + m must be <= 256 in GF(2^8)")
        self.k = data_shards
        self.m = parity_shards
        self.total = data_shards + parity_shards
        self.matrix_kind = matrix_kind
        if matrix is None:
            matrix = gf256.build_matrix(self.k, self.total, matrix_kind)
        self.matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
        if self.matrix.shape != (self.total, self.k):
            raise ValueError(f"matrix shape {self.matrix.shape} is not "
                             f"({self.total}, {self.k})")
        self._decode_cache: dict = {}
        self._plan_cache: dict = {}
        self._syndrome_rows: Optional[np.ndarray] = None

    @classmethod
    def from_matrix(cls, matrix: np.ndarray, **kwargs):
        """A codec over an existing (k+m, k) encode matrix — e.g. another
        codec's ``.matrix`` — so two implementations run on literally
        the same coefficients."""
        total, k = np.shape(matrix)
        return cls(k, total - k, matrix=matrix, **kwargs)

    # -- primitive ---------------------------------------------------------
    def _matmul(self, coeffs: np.ndarray, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # -- device streaming hooks (ops/pipeline.PipelinedMatmul) -------------
    def device_fn(self, coeffs: np.ndarray, width: int):
        """Device-backed codecs return (fn, device-resident constant,
        put) for `width`-wide slabs: ``fn(constant, put(slab))`` launches
        on the device and the constant stays resident across slabs. Host
        codecs return None (no pipeline)."""
        return None

    def pipeline_width_bucket(self, n: int, cap: int) -> int:
        return width_bucket(n, cap)

    # -- public API --------------------------------------------------------
    def encode(self, data: np.ndarray) -> np.ndarray:
        """data (k, n) uint8 -> parity (m, n) uint8."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.shape[0] != self.k:
            raise ValueError(f"expected {self.k} data rows, got {data.shape[0]}")
        return self._matmul(self.matrix[self.k:], data)

    def encode_to_all(self, data: np.ndarray) -> np.ndarray:
        """data (k, n) -> all shards (total, n); data rows verbatim."""
        parity = self.encode(data)
        return np.concatenate([np.asarray(data, dtype=np.uint8), parity], axis=0)

    def _decode_coeffs(self, present: tuple) -> tuple:
        """For a presence tuple, return (src_rows, inv_matrix) where
        data = inv_matrix @ shards[src_rows]."""
        hit = self._decode_cache.get(present)
        if hit is not None:
            return hit
        src = [i for i, p in enumerate(present) if p][: self.k]
        if len(src) < self.k:
            raise ValueError(
                f"too few shards: have {sum(present)}, need {self.k}")
        inv = gf256.mat_inv(self.matrix[src, :])
        self._decode_cache[present] = (src, inv)
        return src, inv

    def decode_plan(self, present: tuple, data_only: bool = False) -> tuple:
        """Fused decode plan for a presence pattern: (src_rows, missing,
        coeffs) with coeffs (len(missing), k) such that ALL missing rows
        — data and parity stacked — come from ONE matmul against the
        first k survivors. Cached per (present, data_only)."""
        key = (tuple(present), bool(data_only))
        hit = self._plan_cache.get(key)
        if hit is not None:
            return hit
        src, inv = self._decode_coeffs(key[0])
        limit = self.k if data_only else self.total
        missing = [i for i in range(limit) if not present[i]]
        coeffs = gf256.decode_coeff_rows(self.matrix, self.k, src,
                                         missing, inv=inv)
        plan = (src, missing, coeffs)
        self._plan_cache[key] = plan
        return plan

    def lost_row_coeffs(self, present: tuple, sid: int) -> tuple:
        """Single-shard slice of the fused decode plan: (src_rows,
        coeffs) with coeffs (1, k) such that shard[sid] = coeffs @
        shards[src_rows]."""
        src, missing, coeffs = self.decode_plan(tuple(present))
        if sid not in missing:
            raise ValueError(f"shard {sid} is not missing in {present}")
        r = missing.index(sid)
        return src, np.ascontiguousarray(coeffs[r:r + 1])

    def reconstruct(self, shards: Sequence[Optional[np.ndarray]],
                    data_only: bool = False) -> List[np.ndarray]:
        """Fill in missing (None) shards. Returns the full shard list
        (data-only mode leaves missing parity as None).

        All missing rows are regenerated by a single fused matmul
        (decode_plan), and device codecs answer sub-small_dispatch_bytes
        widths on the host."""
        shards = list(shards)
        if len(shards) != self.total:
            raise ValueError(f"expected {self.total} shards, got {len(shards)}")
        present = tuple(s is not None for s in shards)
        if all(present):
            return shards
        lens = {s.shape[-1] for s in shards if s is not None}
        if len(lens) != 1:
            raise ValueError("surviving shards have differing lengths")
        with tracing.span("plan", backend=self.backend):
            src, missing, coeffs = self.decode_plan(present, data_only)
        if not missing:
            return shards
        survivors = np.stack([np.asarray(shards[i], dtype=np.uint8)
                              for i in src], axis=0)
        out = self.crossover_matmul(coeffs, survivors)
        for r, i in enumerate(missing):
            shards[i] = out[r]
        return shards

    def crossover_matmul(self, coeffs: np.ndarray,
                         data: np.ndarray) -> np.ndarray:
        """coeffs @ data through the host/device crossover
        (``dispatch_threshold``): widths below it run host_matmul and
        count a host_fallback, the others take _matmul. reconstruct()
        and the sync flat rebuild multiply through it, in a
        ``reconstruct`` span: the JAX tags (``bytes``, the survivors'
        bytes, and ``path``) and ``width``, what the tuner learns from
        (``stats/metrics.observe_span``)."""
        width = int(data.shape[1])
        thr = dispatch_threshold(self)
        small = bool(thr) and width < thr
        with tracing.span("reconstruct", backend=self.backend,
                          bytes=int(data.nbytes), width=width,
                          path="host" if small else "device"):
            if small:
                STATS.add("host_fallbacks")
                return host_matmul(coeffs, data)
            return self._matmul(coeffs, data)

    def verify(self, shards: Sequence[np.ndarray]) -> bool:
        """True iff parity rows match the data rows."""
        data = np.stack([np.asarray(s, dtype=np.uint8)
                         for s in shards[: self.k]], axis=0)
        parity = self.encode(data)
        for i in range(self.m):
            if not np.array_equal(parity[i],
                                  np.asarray(shards[self.k + i], dtype=np.uint8)):
                return False
        return True

    def syndrome_plan(self) -> np.ndarray:
        """Parity-check rows H = [P | I_m], shape (m, k+m): for a
        consistent codeword column x, H @ x = P @ data XOR parity = 0."""
        if self._syndrome_rows is None:
            h = np.zeros((self.m, self.total), dtype=np.uint8)
            h[:, : self.k] = self.matrix[self.k:]
            h[:, self.k:] = np.eye(self.m, dtype=np.uint8)
            self._syndrome_rows = np.ascontiguousarray(h)
        return self._syndrome_rows


class NumpyCodec(ReedSolomonCodec):
    """Pure-numpy reference backend — the conformance oracle."""

    backend = "numpy"

    def _matmul(self, coeffs: np.ndarray, data: np.ndarray) -> np.ndarray:
        return host_matmul(coeffs, data)


def dispatch_threshold(codec) -> int:
    """Live host/device crossover width of a codec (reconstruct, the
    degraded reads and the scrub): the tuner's installed override, else
    the codec's small_dispatch_bytes; a host-only codec (0) never
    delegates to the device."""
    if not codec.small_dispatch_bytes:
        return 0
    ov = _SMALL_DISPATCH_OVERRIDE
    return ov if ov is not None else codec.small_dispatch_bytes


def get_codec(data_shards: int, parity_shards: int,
              backend: str = "cuda",
              matrix_kind: str = "vandermonde",
              device: str = "cuda", mesh=None) -> ReedSolomonCodec:
    """"mesh" is parallel/mesh_codec.MeshCodec over ``mesh`` (a
    parallel/mesh.Mesh; every card when None), and takes no
    ``device``."""
    if backend == "numpy":
        return NumpyCodec(data_shards, parity_shards, matrix_kind)
    if backend == "cuda":
        from .rs_torch import TorchCodec
        return TorchCodec(data_shards, parity_shards, matrix_kind,
                          device=device)
    if backend == "mesh":
        from ..parallel.mesh_codec import MeshCodec
        return MeshCodec(data_shards, parity_shards, matrix_kind, mesh=mesh)
    raise ValueError(f"unknown backend {backend!r}")


# ---------------------------------------------------------------------------
# Plan cache
# ---------------------------------------------------------------------------

#: Entries each plan cache keeps (the JAX package's SW_EC_PLAN_CACHE_SIZE
#: default; the port reads no knob from the environment).
PLAN_CACHE_SIZE = 128


#: Every live plan cache, for the summed reports.
_PLAN_CACHES: "weakref.WeakSet" = weakref.WeakSet()


class _PlanLRU:
    """Bounded LRU for derived GF plans, counting its own hits, misses
    and evictions. It holds host-side plan objects, and identity is
    stable across repeated gets: ``plan_fn(...) is plan_fn(...)``."""

    def __init__(self, name: str, maxsize: int = PLAN_CACHE_SIZE):
        self.name = name
        self._maxsize = max(int(maxsize), 1)
        self._entries: OrderedDict = OrderedDict()
        self.hits = self.misses = self.evictions = 0
        _PLAN_CACHES.add(self)

    def get(self, key, make):
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            return hit
        self.misses += 1
        val = make()
        self._entries[key] = val
        while len(self._entries) > self._maxsize:
            self._entries.popitem(last=False)
            self.evictions += 1
        return val

    def __len__(self):
        return len(self._entries)


def plan_cache_info() -> Dict[str, dict]:
    """Each plan cache's hits, misses, size bound, entries and
    evictions."""
    return {c.name: {"hits": c.hits, "misses": c.misses,
                     "maxsize": c._maxsize, "currsize": len(c),
                     "evictions": c.evictions}
            for c in sorted(list(_PLAN_CACHES), key=lambda c: c.name)}


def plan_cache_stats() -> dict:
    """Cumulative hit/miss/evict event counts, summed over the plan
    caches, plus the current entry count of each."""
    caches = list(_PLAN_CACHES)
    return {
        "events": {event: sum(getattr(c, event) for c in caches)
                   for event in ("hits", "misses", "evictions")},
        "entries": {c.name: len(c) for c in caches},
    }


# ---------------------------------------------------------------------------
# Trace repair of a single lost shard (arxiv 2205.11015).
#
# A dual codeword g satisfies sum_i g[i]*c_i = 0 over every stripe, so
#     Tr(g[lost]*c_lost) = sum_{i != lost} Tr(g[i]*c_i).
# Pick 8 dual codewords whose values at the lost position are
# GF(2)-independent and every bit of c_lost is a GF(2) combination of the
# trace bits Tr(g_j[i]*c_i). Helper i only has to ship
# t_i = dim_2 span{g_j[i]} bits per byte -- its projection onto a reduced
# basis of that span -- instead of all 8, which is where the sub-k*slab
# repair bandwidth comes from. The rebuilder's combine is a
# {0,1}-coefficient GF(2^8) matmul (XOR of bit-planes), so the pipelined
# kernel runs it unchanged: one dispatch per slab.
# ---------------------------------------------------------------------------

REPAIR_MAX_SUBSETS = 400   # cap on vanish-subset enumeration (RS(20,4))
REPAIR_RESTARTS = 3        # greedy restarts with shuffled candidate order


@dataclass(frozen=True, eq=False)
class RepairPlan:
    """Single-lost-shard trace-repair scheme for one geometry.

    helpers lists the shard ids that must be contacted (t_i > 0 only);
    masks[sid] are the GF(2^8) projection masks that holder applies (one
    packed bit-plane per mask); combine is the (8, total_bits) {0,1}
    matrix that XORs the concatenated symbol planes back into the lost
    shard's 8 bit-planes, in helpers-then-mask order.
    """

    k: int
    m: int
    lost: int
    helpers: Tuple[int, ...]
    masks: Dict[int, Tuple[int, ...]] = field(hash=False)
    combine: np.ndarray = field(hash=False)
    matrix_kind: str = "vandermonde"

    @property
    def total_bits(self) -> int:
        return sum(len(v) for v in self.masks.values())

    @property
    def frac(self) -> float:
        """Repair symbol bits per stripe byte vs the k-byte baseline."""
        return self.total_bits / (8.0 * self.k)

    def bits_for(self, sid: int) -> int:
        return len(self.masks[sid])

    def wire_bytes(self, width: int) -> int:
        """Bytes the helpers ship for a width-byte slab range (packed
        planes)."""
        return self.total_bits * ((width + 7) // 8)


def project_slab(data: np.ndarray, masks) -> np.ndarray:
    """Holder-side projection: trace bits Tr(mask * data) packed
    little-bit-first per mask. data (w,) uint8 -> (len(masks),
    ceil(w/8)) uint8. One LUT gather + packbits on the holder's host."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    m = np.asarray(list(masks), dtype=np.uint8)
    bits = gf256.TRACE_MUL[m[:, None], data[None, :]]
    return np.packbits(bits, axis=1, bitorder="little")


def combine_planes_to_bytes(planes: np.ndarray, width: int) -> np.ndarray:
    """Rebuilder-side interleave: 8 packed output bit-planes (8,
    ceil(width/8)) -> the lost shard's bytes (width,). Plane b holds bit b
    of every output byte."""
    bits = np.unpackbits(np.ascontiguousarray(planes, dtype=np.uint8),
                         axis=1, count=width, bitorder="little")
    return np.packbits(bits, axis=0, bitorder="little").reshape(-1)


_REPAIR_PLAN_CACHE = _PlanLRU("repair")


def repair_plan(k: int, m: int, lost_sid: int, survivors=None,
                matrix_kind: str = "vandermonde",
                matrix: Optional[np.ndarray] = None,
                seed: int = 0) -> RepairPlan:
    """Build (and cache) the trace-repair scheme for one lost shard.

    survivors: iterable of reachable shard ids (default: all others).
    Unreachable positions are handled by forcing every dual codeword to
    vanish there, which needs n - 1 - len(survivors) <= m - 1; with fewer
    survivors than k the code cannot repair at all and this raises
    ValueError.

    The search enumerates dual codewords supported off an (m-1)-subset of
    positions (nullspace of the transposed generator restricted to the
    complement), scales each by all 255 nonzero constants, and greedily
    picks 8 equations minimizing the total per-helper GF(2) span growth.
    It draws from np.random.default_rng(seed) in the JAX package's order,
    so every process, and either package, derives the identical plan.
    """
    n = k + m
    if not (0 <= lost_sid < n):
        raise ValueError(f"lost shard {lost_sid} outside 0..{n - 1}")
    if survivors is None:
        survivors = [i for i in range(n) if i != lost_sid]
    helpers = sorted(set(int(s) for s in survivors) - {lost_sid})
    unavailable = [i for i in range(n) if i != lost_sid and i not in helpers]
    if len(unavailable) > m - 1:
        raise ValueError(
            f"too few survivors: {len(helpers)} reachable, need >= {k}")
    key = (k, m, lost_sid, tuple(helpers), matrix_kind,
           None if matrix is None else matrix.tobytes(), seed)
    return _REPAIR_PLAN_CACHE.get(
        key, lambda: _build_repair_plan(k, m, lost_sid, helpers, unavailable,
                                        matrix_kind, matrix, seed))


def _build_repair_plan(k, m, lost_sid, helpers, unavailable, matrix_kind,
                       matrix, seed) -> RepairPlan:
    n = k + m
    if matrix is None:
        matrix = gf256.build_matrix(k, n, matrix_kind)

    # -- candidate dual codewords: vanish on unavailable + an
    #    (m-1-|unavailable|)-subset of helpers ---------------------------
    free = m - 1 - len(unavailable)
    subsets = list(itertools.combinations(helpers, free))
    rng = np.random.default_rng(seed)
    if len(subsets) > REPAIR_MAX_SUBSETS:
        idx = rng.choice(len(subsets), size=REPAIR_MAX_SUBSETS,
                         replace=False)
        subsets = [subsets[i] for i in sorted(idx)]
    base = []
    for sub in subsets:
        vanish = set(unavailable) | set(sub)
        support = [i for i in range(n) if i not in vanish]
        g_u = gf256.gf_nullspace(matrix[support, :].T)
        if g_u is None:
            continue
        g = np.zeros(n, dtype=np.uint8)
        g[support] = g_u
        if g[lost_sid] == 0:
            continue
        base.append(g)
    if not base:
        raise ValueError("no usable dual codewords for this geometry")
    base = np.stack(base, axis=0)
    betas = np.arange(1, 256, dtype=np.uint8)
    cand = gf256.MUL_TABLE[betas[None, :, None], base[:, None, :]]
    cand = cand.reshape(-1, n)

    # -- greedy scheme selection (restarts keep the best) ----------------
    best = None
    for r in range(REPAIR_RESTARTS):
        order = rng.permutation(cand.shape[0]) if r else \
            np.arange(cand.shape[0])
        cv = cand[order]
        chosen = []
        star_basis: list = []
        pos_basis = {i: [] for i in helpers}
        total = 0
        for _ in range(8):
            ok = gf256.gf2_reduce(cv[:, lost_sid], star_basis) != 0
            cost = np.zeros(cv.shape[0], dtype=np.int32)
            for i in helpers:
                cost += (gf256.gf2_reduce(cv[:, i], pos_basis[i]) != 0
                         ).astype(np.int32)
            c = int(np.argmin(np.where(ok, cost, np.int32(1 << 20))))
            chosen.append(cv[c].copy())
            gf256.gf2_insert(star_basis, int(cv[c, lost_sid]))
            for i in helpers:
                if gf256.gf2_insert(pos_basis[i], int(cv[c, i])):
                    total += 1
        if best is None or total < best[0]:
            best = (total, chosen, {i: list(pos_basis[i]) for i in helpers})

    _, chosen, bases = best
    active = [i for i in helpers if bases[i]]
    masks = {i: tuple(bases[i]) for i in active}

    # -- combine matrix: bits(c_lost) = inv(A) @ Lambda @ sigma ----------
    a = np.zeros((8, 8), dtype=np.uint8)
    for j, g in enumerate(chosen):
        for b in range(8):
            a[j, b] = gf256.TRACE_MUL[int(g[lost_sid]), 1 << b]
    lam = np.zeros((8, sum(len(masks[i]) for i in active)), dtype=np.uint8)
    for j, g in enumerate(chosen):
        col = 0
        for i in active:
            coords = gf256.gf2_decompose(int(g[i]), masks[i])
            lam[j, col:col + len(coords)] = coords
            col += len(coords)
    combine = (gf256.gf2_mat_inv(a).astype(np.int32) @
               lam.astype(np.int32)) % 2
    return RepairPlan(k=k, m=m, lost=lost_sid, helpers=tuple(active),
                      masks=masks, combine=combine.astype(np.uint8),
                      matrix_kind=matrix_kind)


def repair_gain(plan: RepairPlan) -> float:
    """Fraction of the k*slab baseline saved by trace repair (0 = no
    gain)."""
    return 1.0 - plan.frac


# ---------------------------------------------------------------------------
# Piggybacked sub-chunk layout.
#
# Each shard is split into alpha = 2^npairs sub-chunks per window
# (npairs = min(k//2, pair cap) data-shard pairs). Data shards stay
# verbatim; parity shard j's sub-chunk z couples each data shard i (pair
# p = i>>1, side b = i&1) with its partner sub-chunk across bit p:
#
#   P_j[z] = XOR_i  a[j,i]*s_i[z]  ^  [z_p == b] * c[j,i]*s_i[z ^ 2^p]
#
# with a = the flat RS parity rows and c[j,i] = theta_j * a[j,i] (theta
# distinct per parity). The gate [z_p == b] makes single-data-shard
# repair plane-local: (k+1)/(2k) of k*shard, 0.55 for RS(10,4).
#
# Full decode of any <= m lost shards block-diagonalizes over cosets of
# span{2^{p(i)} : i lost}, so the slab hot path is still ONE fused
# (missing*alpha, src*alpha) GF matmul per window-split slab. theta is
# chosen by a deterministic seed search that sweeps every (lost-data,
# parity-subset) pattern at plan build; known-good seeds are pinned.
# ---------------------------------------------------------------------------

PIGGYBACK_MAX_PAIRS = 5            # alpha capped at 2^5 = 32 sub-chunks
#: Pair cap for new encodes (the JAX package's SW_EC_PIGGYBACK_PAIRS
#: default); ``pairs=`` pins an existing volume's geometry.
PIGGYBACK_PAIRS = 5
PIGGYBACK_SEED_TRIES = 32          # theta seed search bound
# geometry -> verified theta seed (the MDS sweep still reruns once per
# process at plan build; these just skip the failed-seed prefix)
PIGGYBACK_KNOWN_SEEDS = {
    (10, 4): 5, (6, 3): 0, (20, 4): 1, (4, 2): 0, (8, 3): 0, (12, 4): 8,
}


def piggyback_supported(k: int, m: int) -> bool:
    """Geometries the piggyback layout accepts: >= 2 parities (the
    repair plane solves a 2x2 per z) and >= 1 data pair."""
    return m >= 2 and k >= 2 and k + m <= 256


@dataclass(frozen=True, eq=False)
class PiggybackPlan:
    """Verified coupled-layout geometry: encode matrix + coupling
    coefficients. emat is the (m*alpha, k*alpha) block matrix a single
    batched GF matmul applies per window-split slab."""

    k: int
    m: int
    npairs: int
    alpha: int
    theta_seed: int
    matrix_kind: str = "vandermonde"
    amat: np.ndarray = field(hash=False, default=None)
    cmat: np.ndarray = field(hash=False, default=None)
    emat: np.ndarray = field(hash=False, default=None)

    @property
    def coupled(self) -> int:
        """Number of data shards with a coupling partner (cheap repair)."""
        return 2 * self.npairs

    @property
    def repair_frac(self) -> float:
        """Single-coupled-data-shard repair download vs k*shard."""
        return (self.k + 1) / (2.0 * self.k)

    def syndrome_rows(self) -> np.ndarray:
        """[E | I] over flattened sub-chunk columns: zero syndrome iff
        the window's parity sub-chunks match the coupled encode."""
        ka, ma = self.k * self.alpha, self.m * self.alpha
        h = np.zeros((ma, ka + ma), dtype=np.uint8)
        h[:, :ka] = self.emat
        h[:, ka:] = np.eye(ma, dtype=np.uint8)
        return h


def _pb_build(k: int, m: int, matrix_kind: str, matrix, theta_seed: int,
              cap: int):
    """(a, c) coefficient rows for one theta seed."""
    n = k + m
    if matrix is None:
        matrix = gf256.build_matrix(k, n, matrix_kind)
    a = np.ascontiguousarray(matrix[k:])
    npairs = min(k // 2, cap)
    theta = [gf256.EXP_TABLE[(theta_seed * m + j) * 11 % 255]
             for j in range(m)]
    if len(set(theta)) != m:
        raise ValueError("theta collision — geometry too wide for seed")
    c = gf256.MUL_TABLE[np.asarray(theta, dtype=np.uint8)[:, None], a]
    c[:, 2 * npairs:] = 0
    return a, c, npairs, 1 << npairs


def _pb_encode_matrix(k, m, a, c, npairs, alpha) -> np.ndarray:
    emat = np.zeros((m * alpha, k * alpha), dtype=np.uint8)
    for j in range(m):
        for z in range(alpha):
            r = j * alpha + z
            for i in range(k):
                emat[r, i * alpha + z] ^= a[j, i]
                if i < 2 * npairs:
                    p, b = i >> 1, i & 1
                    if (z >> p) & 1 == b:
                        emat[r, i * alpha + (z ^ (1 << p))] ^= c[j, i]
    return emat


def _pb_decode_block(k, m, a, c, npairs, lostF, pJ):
    """Per-coset solve for lost data shards lostF from parities pJ:
    (Minv, V) with V the coupling span (coset offsets) and Minv the
    (f*|V|, f*|V|) inverse, or None when singular. Unknown order is
    (i in sorted F) x (v in V); equation order (j in pJ) x (v in V)."""
    F = sorted(lostF)
    f = len(F)
    V = [0]
    for p in sorted(set(i >> 1 for i in F if i < 2 * npairs)):
        V = V + [v | (1 << p) for v in V]
    t2 = len(V)
    vidx = {v: e for e, v in enumerate(V)}
    mat = np.zeros((f * t2, f * t2), dtype=np.uint8)
    for je, j in enumerate(pJ):
        for ve, v in enumerate(V):
            r = je * t2 + ve
            for ui, i in enumerate(F):
                mat[r, ui * t2 + ve] ^= a[j, i]
                if i < 2 * npairs:
                    p, b = i >> 1, i & 1
                    if (v >> p) & 1 == b:
                        mat[r, ui * t2 + vidx[v ^ (1 << p)]] ^= c[j, i]
    try:
        return gf256.mat_inv(mat), V
    except ValueError:  # singular candidate
        return None


def _pb_mds_sweep(k, m, a, c, npairs) -> bool:
    """True iff every (lost-data, parity-subset) pattern is decodable."""
    for f in range(1, m + 1):
        for F in itertools.combinations(range(k), f):
            for J in itertools.combinations(range(m), f):
                if _pb_decode_block(k, m, a, c, npairs, F, J) is None:
                    return False
    return True


_PIGGYBACK_PLAN_CACHE = _PlanLRU("piggyback")
_PIGGYBACK_REPAIR_CACHE = _PlanLRU("piggyback_repair")
_PIGGYBACK_DECODE_CACHE = _PlanLRU("piggyback_decode")


def piggyback_plan(k: int, m: int, matrix_kind: str = "vandermonde",
                   matrix: Optional[np.ndarray] = None,
                   pairs: Optional[int] = None) -> PiggybackPlan:
    """Build (and cache) the verified coupled-layout plan for a
    geometry. Deterministic: the theta seed search starts from the
    pinned known-good seed when the geometry has one, and every
    candidate must pass the exhaustive node-MDS sweep before the plan
    is returned.

    ``pairs`` pins the pair cap for an already-encoded volume (from its
    sidecar); new encodes leave it None and take PIGGYBACK_PAIRS."""
    if not piggyback_supported(k, m):
        raise ValueError(
            f"piggyback layout needs m >= 2 and k >= 2, got RS({k},{m})")
    cap = PIGGYBACK_PAIRS if pairs is None else pairs
    cap = max(1, min(int(cap), PIGGYBACK_MAX_PAIRS))
    key = (k, m, matrix_kind, cap,
           None if matrix is None else matrix.tobytes())
    return _PIGGYBACK_PLAN_CACHE.get(
        key, lambda: _build_piggyback_plan(k, m, matrix_kind, matrix, cap))


def _build_piggyback_plan(k, m, matrix_kind, matrix, cap) -> PiggybackPlan:
    known = PIGGYBACK_KNOWN_SEEDS.get((k, m))
    order = list(range(PIGGYBACK_SEED_TRIES))
    if known is not None:
        order.remove(known)
        order.insert(0, known)
    for seed in order:
        a, c, npairs, alpha = _pb_build(k, m, matrix_kind, matrix, seed,
                                        cap)
        if _pb_mds_sweep(k, m, a, c, npairs):
            emat = _pb_encode_matrix(k, m, a, c, npairs, alpha)
            return PiggybackPlan(k=k, m=m, npairs=npairs, alpha=alpha,
                                 theta_seed=seed, matrix_kind=matrix_kind,
                                 amat=a, cmat=c, emat=emat)
    raise ValueError(
        f"no MDS theta seed within {PIGGYBACK_SEED_TRIES} tries for "
        f"RS({k},{m}) {matrix_kind}")


@dataclass(frozen=True, eq=False)
class PiggybackRepairPlan:
    """Half-plane repair of one coupled data shard. Every helper (the k-1
    other data shards + the two parity_sids) ships the sub-chunks
    {z : bit plane_bit of z == plane_side}; matrix is the
    (alpha, (k+1)*alpha/2) combine applied per window -- one fused matmul
    rebuilds the lost shard bit-identically."""

    k: int
    m: int
    lost: int
    alpha: int
    plane_bit: int
    plane_side: int
    data_helpers: Tuple[int, ...]
    parity_sids: Tuple[int, ...]
    matrix: np.ndarray = field(hash=False, default=None)
    matrix_kind: str = "vandermonde"

    @property
    def helpers(self) -> Tuple[int, ...]:
        return self.data_helpers + self.parity_sids

    @property
    def frac(self) -> float:
        """Downloaded bytes vs the k*shard full-rebuild baseline."""
        return len(self.helpers) / (2.0 * self.k)

    def plane(self) -> Tuple[int, ...]:
        return tuple(z for z in range(self.alpha)
                     if (z >> self.plane_bit) & 1 == self.plane_side)

    def wire_bytes(self, shard_bytes: int) -> int:
        """Bytes the helpers ship for whole-shard repair (half a shard
        each)."""
        return len(self.helpers) * (shard_bytes // 2)


def piggyback_repair_plan(k: int, m: int, lost_sid: int,
                          parity_sids=None,
                          matrix_kind: str = "vandermonde",
                          matrix: Optional[np.ndarray] = None,
                          pairs: Optional[int] = None
                          ) -> PiggybackRepairPlan:
    """Build (and cache) the half-plane repair scheme for one lost COUPLED
    data shard. parity_sids: the two reachable parity shard ids to use
    (absolute, >= k; default the first two). Uncoupled shards (odd-k
    tail, parity shards) have no plane scheme. ``pairs`` pins an encoded
    volume's pair cap, as for piggyback_plan."""
    pplan = piggyback_plan(k, m, matrix_kind, matrix, pairs=pairs)
    if not (0 <= lost_sid < pplan.coupled):
        raise ValueError(
            f"shard {lost_sid} is not a coupled data shard "
            f"(coupled: 0..{pplan.coupled - 1})")
    if parity_sids is None:
        parity_sids = (k, k + 1)
    pj = tuple(sorted(int(s) for s in parity_sids))
    if len(pj) != 2 or not all(k <= s < k + m for s in pj):
        raise ValueError(f"need exactly two parity shard ids, got {pj}")
    key = (k, m, pplan.npairs, lost_sid, pj, matrix_kind,
           None if matrix is None else matrix.tobytes())
    return _PIGGYBACK_REPAIR_CACHE.get(
        key, lambda: _build_piggyback_repair(pplan, lost_sid, pj))


def _build_piggyback_repair(pplan: PiggybackPlan, lost: int,
                            pj: Tuple[int, int]) -> PiggybackRepairPlan:
    k = pplan.k
    a, c, alpha = pplan.amat, pplan.cmat, pplan.alpha
    npairs = pplan.npairs
    p_, b_ = lost >> 1, lost & 1
    half = alpha // 2
    plane = [z for z in range(alpha) if (z >> p_) & 1 == b_]
    zidx = {z: t for t, z in enumerate(plane)}
    dh = [i for i in range(k) if i != lost]
    j1, j2 = pj[0] - k, pj[1] - k
    minv = gf256.mat_inv(np.array(
        [[a[j1, lost], c[j1, lost]],
         [a[j2, lost], c[j2, lost]]], dtype=np.uint8))
    w = np.zeros((alpha, (len(dh) + 2) * half), dtype=np.uint8)
    colbase = {h: t * half for t, h in enumerate(dh)}
    pbase = {j1: len(dh) * half, j2: (len(dh) + 1) * half}
    mt = gf256.MUL_TABLE
    for z in plane:
        t = zidx[z]
        for col, jp in ((0, j1), (1, j2)):
            # K_jp[z] weights into the two unknowns (s[z], s[z^2^p*])
            for out_z, wc in ((z, minv[0, col]), (z ^ (1 << p_),
                                                  minv[1, col])):
                if wc == 0:
                    continue
                w[out_z, pbase[jp] + t] ^= wc
                for h in dh:
                    ah = mt[wc, a[jp, h]]
                    if ah:
                        w[out_z, colbase[h] + t] ^= ah
                    if h < 2 * npairs:
                        ph, bh = h >> 1, h & 1
                        if (z >> ph) & 1 == bh and c[jp, h]:
                            # gated partner term: stays on the plane
                            # because ph != p* for every helper whose
                            # gate can fire here
                            w[out_z, colbase[h] + zidx[z ^ (1 << ph)]] ^= \
                                mt[wc, c[jp, h]]
    return PiggybackRepairPlan(
        k=k, m=pplan.m, lost=lost, alpha=alpha, plane_bit=p_, plane_side=b_,
        data_helpers=tuple(dh), parity_sids=pj, matrix=w,
        matrix_kind=pplan.matrix_kind)


def piggyback_decode_plan(k: int, m: int, present,
                          matrix_kind: str = "vandermonde",
                          matrix: Optional[np.ndarray] = None,
                          pairs: Optional[int] = None):
    """Fused full decode for a presence pattern on the coupled layout:
    returns (src_sids, missing_sids, coeffs) with coeffs
    (len(missing)*alpha, len(src)*alpha) so every missing shard — data
    and parity — comes from ONE window-split matmul against the
    survivors. src is every surviving data shard plus as many parities
    as there are missing data shards (k shards read, as on the flat
    layout)."""
    pplan = piggyback_plan(k, m, matrix_kind, matrix, pairs=pairs)
    key = (k, m, tuple(bool(p) for p in present), matrix_kind,
           pplan.npairs,
           None if matrix is None else matrix.tobytes())
    return _PIGGYBACK_DECODE_CACHE.get(
        key, lambda: _build_piggyback_decode(pplan, key[2]))


def _build_piggyback_decode(pplan: PiggybackPlan, present):
    k, m, alpha = pplan.k, pplan.m, pplan.alpha
    n = k + m
    if len(present) != n:
        raise ValueError(f"presence tuple must have {n} entries")
    a, c, npairs = pplan.amat, pplan.cmat, pplan.npairs
    missing = [i for i in range(n) if not present[i]]
    lost_data = [i for i in missing if i < k]
    f = len(lost_data)
    live_data = [i for i in range(k) if present[i]]
    live_par = [j for j in range(m) if present[k + j]]
    if len(live_data) + len(live_par) < k:
        raise ValueError(
            f"too few shards: have {sum(present)}, need {k}")
    use_par = live_par[:f]
    src = live_data + [k + j for j in use_par]
    src_col = {s: t * alpha for t, s in enumerate(src)}
    # L: full data flat (k*alpha) as a GF-linear map of the src stack
    ldat = np.zeros((k * alpha, len(src) * alpha), dtype=np.uint8)
    for i in live_data:
        for z in range(alpha):
            ldat[i * alpha + z, src_col[i] + z] = 1
    if f:
        blk = _pb_decode_block(k, m, a, c, npairs, lost_data, use_par)
        if blk is None:
            raise ValueError(
                "singular decode pattern — layout verification bug")
        minv, v_span = blk
        t2 = len(v_span)
        mask = 0
        for v in v_span:
            mask |= v
        fs = sorted(lost_data)
        for z0 in range(alpha):
            if z0 & mask:
                continue
            # K rows for this coset, as rows over the src stack
            krows = np.zeros((f * t2, len(src) * alpha), dtype=np.uint8)
            for je, j in enumerate(use_par):
                for ve, v in enumerate(v_span):
                    z = z0 | v
                    r = je * t2 + ve
                    krows[r, src_col[k + j] + z] ^= 1
                    for h in live_data:
                        krows[r, src_col[h] + z] ^= a[j, h]
                        if h < 2 * npairs:
                            ph, bh = h >> 1, h & 1
                            if (z >> ph) & 1 == bh and c[j, h]:
                                krows[r, src_col[h] + (z ^ (1 << ph))] ^= \
                                    c[j, h]
            sol = gf256.mat_mul(minv, krows)
            for ui, i in enumerate(fs):
                for ve, v in enumerate(v_span):
                    ldat[i * alpha + (z0 | v)] = sol[ui * t2 + ve]
    rows = []
    for s in missing:
        if s < k:
            rows.append(ldat[s * alpha:(s + 1) * alpha])
        else:
            j = s - k
            erows = pplan.emat[j * alpha:(j + 1) * alpha]
            rows.append(gf256.mat_mul(erows, ldat))
    coeffs = np.concatenate(rows, axis=0) if rows else \
        np.zeros((0, len(src) * alpha), dtype=np.uint8)
    return src, missing, np.ascontiguousarray(coeffs)


# -- sub-chunk window transforms (host numpy reshapes) -----------------------

def pb_window(small_block: int, alpha: int) -> int:
    """Sub-chunk window: every window bytes of a shard split into alpha
    interleaved sub-chunks. The window is the small stripe block, which
    divides every shard size the two-level striping can produce; it
    must itself be alpha-divisible."""
    if small_block % alpha:
        raise ValueError(
            f"small block {small_block} not divisible by alpha {alpha}")
    return small_block


def pb_split(rows: np.ndarray, alpha: int, window: int) -> np.ndarray:
    """(r, W) shard rows -> (r*alpha, W/alpha) sub-chunk rows, window
    by window; W must be window-aligned. Row order (shard-major,
    sub-chunk z) matches the encode/decode matrix column order."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    r, width = rows.shape
    if width % window:
        raise ValueError(f"width {width} not aligned to window {window}")
    wsub = window // alpha
    x = rows.reshape(r, width // window, alpha, wsub)
    return np.ascontiguousarray(
        x.transpose(0, 2, 1, 3).reshape(r * alpha, width // alpha))


def pb_merge(flat: np.ndarray, alpha: int, window: int) -> np.ndarray:
    """Inverse of pb_split: (r*alpha, W/alpha) -> (r, W)."""
    wsub = window // alpha
    ra, cols = flat.shape
    r = ra // alpha
    x = flat.reshape(r, alpha, cols // wsub, wsub)
    return np.ascontiguousarray(
        x.transpose(0, 2, 1, 3).reshape(r, cols * alpha))


def pb_plane_slice(shard: np.ndarray, alpha: int, window: int,
                   plane_bit: int, plane_side: int) -> np.ndarray:
    """Holder-side half-plane extraction: the repair protocol ships
    exactly these bytes. (W,) -> (W/2,) -- the plane's sub-chunks in
    increasing z, window-major, so the rebuilder's pb_plane_rows can
    restack them without knowing the holder's file layout."""
    shard = np.ascontiguousarray(shard, dtype=np.uint8)
    wsub = window // alpha
    zs = [z for z in range(alpha) if (z >> plane_bit) & 1 == plane_side]
    x = shard.reshape(-1, alpha, wsub)
    return np.ascontiguousarray(x[:, zs, :].reshape(-1))


def pb_plane_rows(plane: np.ndarray, alpha: int, window: int) -> np.ndarray:
    """Rebuilder-side restack of one helper's plane bytes:
    (W/2,) -> (alpha/2, W/alpha) rows in plan column order."""
    half = alpha // 2
    wsub = window // alpha
    x = plane.reshape(-1, half, wsub)
    return np.ascontiguousarray(
        x.transpose(1, 0, 2).reshape(half, -1))
