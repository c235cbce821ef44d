"""What each part of the bit-plane kernel's work costs on the card.

    python3 -m seaweedfs_tpu_torch.tools.bitplane_parts

builds csrc/gf_bitplane.cu once for each mask of ``SKIPS`` (nvcc with
``-DGF_BP_SKIP=<mask>``, one process per build, all started together,
into ``build/parts<mask>/``) and times every bit-plane variant of each
build at RS(10,4) x 8 MiB and at the piggyback emat (128,320) x 262,144,
seed 7, with ``kernel_exp.per_launch_ms``. It makes two passes over the
builds, masks up and then down, and prints both, so the spread between
passes reads beside the differences between builds. Mask 0 is the
library the port builds, and its output is held against the numpy oracle.
The other builds compute wrong bytes on purpose. Their mask bits are
1 for no wgmma, 2 for no output store and 4 for no payload load. Each
variant's line also gives the bound of the function (kernel_exp.bound
with the lift's ones).

The last line of output is one JSON object: {"card", "rows": [{"shape",
"variant", "mask", "ms": [pass 1, pass 2]}]}.
"""

from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import codec as ops_codec, gf256, rs_bitplane
from ..ops.codec import host_matmul
from ..ops.rs_hopper import BUILD_DIR, build_library
from . import kernel_exp

#: parts mask -> what the build leaves out
SKIPS = {0: "full", 1: "no wgmma", 2: "no store", 4: "no load",
         6: "no load, no store", 7: "no wgmma, load or store"}


def build_all(masks=tuple(SKIPS)) -> dict:
    """{mask: typed library}, one nvcc per mask, all started together."""
    def build(mask):
        path = BUILD_DIR / f"parts{mask}" / rs_bitplane.LIBRARY.name
        build_library(rs_bitplane.SOURCE, path,
                      defines=(f"GF_BP_SKIP={mask}",))
        return mask, rs_bitplane.bind(path)
    with ThreadPoolExecutor(max_workers=len(masks)) as pool:
        return dict(pool.map(build, masks))


def shapes():
    """(label, coeffs, n): the flat RS(10,4) encode at 8 MiB and the
    piggyback emat at its slab width."""
    return (("(4,10)x8MiB", gf256.build_matrix(10, 14)[10:], 8 << 20),
            ("(128,320)x262144", ops_codec.piggyback_plan(10, 4).emat,
             262_144))


def run(seed: int = 7) -> list:
    """Times every (shape, variant, mask) in two passes; returns rows."""
    dev = torch.device("cuda")
    libs = build_all()
    order = sorted(libs)
    rows = []
    for label, coeffs, n in shapes():
        r, k = coeffs.shape
        host = np.random.default_rng(seed).integers(0, 256, (k, n),
                                                    dtype=np.uint8)
        data = torch.from_numpy(host).to(dev)
        oracle = host_matmul(coeffs, host)
        lift1 = rs_bitplane.fuse_bitmat(coeffs)
        for u, dtype in ((1, "int8"), (1, "bf16"), (1, "tf32"), (2, "int8"),
                         (2, "bf16"), (4, "int8"), (4, "bf16")):
            lift_np = lift1 if u == 1 else \
                rs_bitplane.block_diag_bitmat(lift1, u)
            lift = torch.from_numpy(lift_np).to(dev)
            plan = rs_bitplane.device_tiles(lift, u, dtype).plan
            bound_ms, bound_by = kernel_exp.bound(
                r, k, n, u, dtype, plan.least_ops_per_column)
            times = {mask: [] for mask in order}
            for mask in order + order[::-1]:
                def fn(a, x, lib=libs[mask]):
                    return rs_bitplane._launch(a, x, r, u, dtype, lib)
                if mask == 0 and not times[0]:
                    got = fn(lift, data).cpu().numpy()
                    if not np.array_equal(got, oracle):
                        raise AssertionError(f"{label} u={u} {dtype}: the "
                                             f"full build is not exact")
                times[mask].append(kernel_exp.per_launch_ms(fn, lift, data))
            name = rs_bitplane.variant_name(u, dtype)
            print(f"{label} {name}: bound {bound_ms:.4f} ms {bound_by}; "
                  + "; ".join(f"{SKIPS[m]} {t[0]:.4f} / {t[1]:.4f} ms"
                              for m, t in times.items()))
            rows += [{"shape": label, "variant": name, "mask": m,
                      "parts": SKIPS[m], "ms": t} for m, t in times.items()]
            del lift
    return rows


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card)
    rows = run()
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
