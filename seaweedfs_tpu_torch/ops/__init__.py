"""ops — GF(2^8) arithmetic and Reed-Solomon codec backends.

Backends:
  numpy — pure-numpy reference implementation (conformance oracle)
  cuda  — the hand-written Hopper kernel (ops/rs_hopper.py) behind
          TorchCodec; its plain PyTorch version on device="cpu"
  mesh  — the same kernel at every position of a mesh
          (parallel/mesh_codec.MeshCodec)

All backends are bit-identical.
"""

from .codec import (NumpyCodec, ReedSolomonCodec, get_codec,  # noqa: F401
                    host_matmul, width_bucket)
from .pipeline import PipelinedMatmul  # noqa: F401
from .rs_hopper import gf_matmul, gf_matmul_plain  # noqa: F401
from .rs_torch import TorchCodec, resolve_device  # noqa: F401
from .telemetry import STATS  # noqa: F401
