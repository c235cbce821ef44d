"""MeshCodec — multi-device EC as a codec backend (``ec_backend="mesh"``).

The counterpart of seaweedfs_tpu/parallel/mesh_codec.py. Every GF(2^8)
product of a codec (encode, the fused decode plan, the pipelined slabs
of write_ec_files and rebuild_ec_files) splits its width over the
'data' positions of a mesh; each position multiplies its column slice
on K1 (ops/rs_hopper.gf_matmul: the kernel on a card, its plain
version on a CPU position) with the whole coefficient matrix. Columns
are independent, so there is no communication, and the bytes equal
every other backend's.

Dispatch discipline, as in the JAX package: K1's plan uploads once per
(matrix, device) through ops/codec._ConstCache, every position is
launched before any output is drained. The chunk loop, the drain and
the pipeline's interface (``lanes``, ``launch``, ``drain_pieces``) are
ops/rs_torch.LaneCodec's, shared with the single-device TorchCodec:
ops/pipeline.PipelinedMatmul stages and copies each position's slice on
its own streams.

Width discipline: the codec mesh puts every position on 'data'
(parallel/mesh.make_codec_mesh); a product below
MESH_SHARD_MIN_BYTES of payload (k x width) runs at position 0 alone;
every sharded put records its bytes per position in ops/telemetry, so
a fall-back to width 1 is a counter, not a surprise in wall time.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ops import device_stats
from ..ops.gf_plan import make_plan
from ..ops.rs_hopper import gf_matmul
from ..ops.rs_torch import Lane, LaneCodec
from ..ops.telemetry import STATS
from .mesh import make_codec_mesh

#: Payload bytes (k x width) below which a product keeps the single
#: position: the JAX package's SW_EC_MESH_SHARD_MIN_BYTES default.
MESH_SHARD_MIN_BYTES = 1 << 20


class MeshCodec(LaneCodec):
    """GF(2^8) codec over a mesh of positions (every card by default; a
    mesh of CPU positions when the caller passes one): a lane per 'data'
    position. The chunk loop and the drain are LaneCodec's."""

    backend = "mesh"
    trace_phases = True

    def __init__(self, data_shards: int, parity_shards: int,
                 matrix_kind: str = "vandermonde", mesh=None,
                 chunk_bytes: int = 32 << 20,
                 small_dispatch_bytes: Optional[int] = None,
                 mesh_shard_min_bytes: int = MESH_SHARD_MIN_BYTES):
        super().__init__(data_shards, parity_shards, matrix_kind,
                         chunk_bytes=chunk_bytes,
                         small_dispatch_bytes=small_dispatch_bytes)
        self.mesh = make_codec_mesh() if mesh is None else mesh
        self.mesh_shard_min_bytes = int(mesh_shard_min_bytes)
        self._positions = [(self.mesh.label(idx), self.mesh.device(idx))
                           for idx in np.ndindex(self.mesh.devices.shape)]

    # -- layout ------------------------------------------------------------
    def _sharded(self, k: int, width: int) -> bool:
        return k * width >= self.mesh_shard_min_bytes and \
            self.mesh.shape["data"] > 1

    def column_multiple(self) -> int:
        return self.mesh.shape["data"]

    def lanes(self, k: int, width: int) -> List[Lane]:
        """The column slices of a (k, width) slab and their positions:
        one per 'data' position when the product is sharded, else the
        whole width at position 0."""
        if not self._sharded(k, width):
            label, dev = self._positions[0]
            return [(label, dev, 0, width)]
        d = self.mesh.shape["data"]
        if width % d:
            raise ValueError(f"width {width} does not split over {d} "
                             f"positions (use pipeline_width_bucket)")
        step = width // d
        return [(label, dev, i * step, (i + 1) * step)
                for i, (label, dev) in enumerate(self._positions[:d])]

    # -- device hooks --------------------------------------------------------
    def _plan(self, coeffs: np.ndarray, dev: torch.device, tag: str):
        """K1's plan of ``coeffs`` on ``dev``: built and uploaded once per
        (matrix, device) and kept (one bitmat_upload each). Each device's
        plan is its own build, so its owner is the cache with the device
        (a second build for one device would be a recompile)."""
        key = (coeffs.shape, coeffs.tobytes(), tag, str(dev))
        return self._consts.get(
            key, lambda: make_plan(coeffs, (self._consts.owner, tag,
                                            str(dev))).to(dev))

    def device_fn(self, coeffs: np.ndarray, width: int):
        """(fn, const, put) for ``width``-wide slabs, ``width`` a
        pipeline_width_bucket. ``put(host)`` splits a (k, width) slab
        into its lanes' tensors (a list of lane tensors is passed on);
        ``fn(const, xs)`` launches K1 at every lane's position before any
        is drained and returns the lanes' outputs [(col_off, tensor)],
        drained by ``drain_pieces``. A sharded put counts one
        mesh_dispatch and its bytes per position; below the crossover
        the single lane runs at position 0 with no mesh dispatch."""
        coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)
        k = coeffs.shape[1]
        lanes = self.lanes(k, width)
        sharded = self._sharded(k, width)
        tag = "mesh" if sharded else "single"
        const = [self._plan(coeffs, dev, tag) for _, dev, _, _ in lanes]

        def put(host) -> List[torch.Tensor]:
            if isinstance(host, list):
                xs = host
            else:
                host = np.asarray(host, dtype=np.uint8)
                xs = [torch.from_numpy(np.ascontiguousarray(
                    host[:, lo:hi])).to(dev) for _, dev, lo, hi in lanes]
            if sharded:
                STATS.add("mesh_dispatches")
                for (label, _, _, _), x in zip(lanes, xs):
                    STATS.add_mesh_device_bytes(label, x.numel())
            return xs

        def fn(plans, xs):
            def run():
                return [(lo, gf_matmul(plan, x))
                        for plan, x, (_, _, lo, _) in zip(plans, xs, lanes)]
            if not sharded:
                return run()
            return device_stats.program(device_stats.MESH_FN,
                                        [dev for _, dev, _, _ in lanes], run)

        return fn, const, put

    def launch(self, coeffs, width, xs):
        fn, const, put = self.device_fn(coeffs, width)
        return fn(const, put(xs))
