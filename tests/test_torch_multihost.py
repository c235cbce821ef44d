"""The port's multi-process tier (seaweedfs_tpu_torch/parallel/
multihost.py) on the CPU: two real processes join one torch.distributed
group over gloo and run the distributed EC step on their global mesh.

With four CPU positions each, the mesh is (4, 2), as the JAX package's
two processes of four virtual devices make it (tests/test_multihost.py),
and each process's summary must pass the JAX test's asserts. With one
position each the mesh is (1, 2): the rebuild's 'shard' group spans the
two processes, so its partial products are all-gathered and XOR-folded
across them. Each process saves the parity blocks it holds; put
together, they must equal the JAX package's in-process
distributed_ec_step on a mesh of the same shape, byte for byte. The
children import neither jax nor the JAX package."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from seaweedfs_tpu.parallel import distributed_ec_step as ref_step
from seaweedfs_tpu.parallel import make_mesh as ref_make_mesh
from seaweedfs_tpu_torch.parallel.multihost import multihost_cpu_capability

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r"""
import json, sys
for name in ("jax", "jaxlib", "seaweedfs_tpu"):
    sys.modules[name] = None
sys.path.insert(0, sys.argv[5])
import numpy as np
import torch
torch.set_num_threads(1)
from seaweedfs_tpu_torch.parallel import init_distributed, multihost_ec_step
from seaweedfs_tpu_torch.parallel.multihost import shutdown
coord, nproc, pid, local = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    int(sys.argv[4])
init_distributed(coord, nproc, pid, devices=["cpu"] * local)
outputs = {}
out = multihost_ec_step(k=10, m=4, n_per_device=256, outputs=outputs)
np.savez(sys.argv[6], **{
    "%d_%d_%d_%d" % (s.rows.start, s.rows.stop, s.cols.start, s.cols.stop):
    s.data.numpy() for s in outputs["parity"].shards})
shutdown()
print("MULTIHOST_RESULT " + json.dumps(out), flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_capability_probe():
    ok, why = multihost_cpu_capability()
    import torch.distributed as dist
    assert ok == (dist.is_available() and dist.is_gloo_available())
    assert ok or why


@pytest.mark.parametrize("local,shape", [(4, (4, 2)), (1, (1, 2))])
def test_two_process_mesh_runs_ec_step(tmp_path, local, shape):
    ok, why = multihost_cpu_capability()
    assert ok, why
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    blocks = [tmp_path / f"parity{pid}.npz" for pid in (0, 1)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CHILD, coord, "2", str(pid), str(local),
             str(ROOT), str(blocks[pid])],
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-3000:]}"
    results = []
    for out in outs:
        line = [ln for ln in out.splitlines()
                if ln.startswith("MULTIHOST_RESULT ")]
        assert line, out[-1000:]
        results.append(json.loads(line[0].split(" ", 1)[1]))
    for pid, r in enumerate(results):
        assert r["ok"] and r["process_index"] == pid
        assert r["process_count"] == 2
        assert r["global_devices"] == 2 * local
        assert r["local_devices"] == local
        assert r["mesh_shape"] == {"data": shape[0], "shard": shape[1]}
        assert r["parity_shards_checked"] > 0
        assert r["rebuilt_shards_checked"] > 0
        assert r["backend"] == "gloo" and r["k1_launches"] == 0
    # the parity blocks of both processes, put together, are JAX's
    n = 256 * shape[0]
    parity = np.full((4, n), -1, dtype=np.int16)
    for path in blocks:
        with np.load(path) as saved:
            for key in saved.files:
                r0, r1, c0, c1 = map(int, key.split("_"))
                parity[r0:r1, c0:c1] = saved[key]
    ref_mesh = ref_make_mesh(shape=shape,
                             devices=jax.devices()[: 2 * local])
    want, _, diff = ref_step(ref_mesh, 10, 4, n_per_device=256)
    assert diff == 0
    assert np.array_equal(parity, want.astype(np.int16))
