"""Multi-process device tier: one mesh over the positions of several
processes, joined by ``torch.distributed``.

The counterpart of seaweedfs_tpu/parallel/multihost.py, where
``jax.distributed.initialize`` makes every process see the global device
list and XLA inserts the cross-process collectives. Here
``init_distributed`` joins the process group (``tcp://`` rendezvous at
the coordinator; NCCL for positions on cards, gloo for CPU positions,
or the backend the caller names; a failure is raised, never answered
with another backend), and ``global_mesh`` lays the ranks' positions
out as one mesh, ranks major. The sharded programs (sharded_ec) run
unchanged on it: each process computes its own positions, and a
rebuild's 'shard' group that spans processes all-gathers its partial
products and XOR-folds them (``xor_all_gather``).

Inputs are built per process from the same seeded host value, each
process taking only its positions' slices (``_global``), and outputs
are checked per process against the numpy oracle on those slices only
(``multihost_ec_step``'s ``check_local``): no process reads another's
bytes except the partials of a spanning fold.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: The positions init_distributed gave this process (the process group
#: itself is process-wide too).
_LOCAL: List[torch.device] = []


def multihost_cpu_capability() -> Tuple[bool, str]:
    """Can this torch run multi-process collectives on CPU positions
    (the gloo backend)? Returns (ok, reason); reason explains a False."""
    import torch.distributed as dist
    if not dist.is_available():
        return False, "torch.distributed is not available in this build"
    if not dist.is_gloo_available():
        return False, "this torch has no gloo backend"
    return True, ""


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int,
                     local_device_ids: Optional[list] = None,
                     backend: Optional[str] = None,
                     devices: Optional[list] = None) -> None:
    """Join the process group at ``tcp://<coordinator_address>`` as rank
    ``process_id`` of ``num_processes``. This process's positions are
    ``devices`` when given (e.g. four ``"cpu"``), else the cards of
    ``local_device_ids`` (every card by default; none raises). The
    backend is ``backend``, else NCCL for cards and gloo for the CPU."""
    import torch.distributed as dist
    if devices is not None:
        positions = [torch.device(d) for d in devices]
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass the "
                               "process's positions (devices=[...])")
        ids = range(torch.cuda.device_count()) if local_device_ids is None \
            else local_device_ids
        positions = [torch.device("cuda", int(i)) for i in ids]
    if not positions:
        raise ValueError("a process needs at least one position")
    if backend is None:
        backend = "nccl" if positions[0].type == "cuda" else "gloo"
    if backend == "nccl":
        # NCCL's object collectives run on the current card
        torch.cuda.set_device(positions[0])
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    _LOCAL[:] = positions


def shutdown() -> None:
    """Leave the process group."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL[:] = []


def local_devices() -> List[torch.device]:
    return list(_LOCAL)


def global_mesh(shape: Optional[Tuple[int, ...]] = None):
    """The mesh of every rank's positions, ranks major, in make_mesh's
    default layout: each rank learns the others' positions once."""
    import torch.distributed as dist
    from .mesh import make_mesh
    everyone: List[list] = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, [str(d) for d in _LOCAL])
    devices, ranks = [], []
    for r, names in enumerate(everyone):
        devices += names
        ranks += [r] * len(names)
    return make_mesh(shape, devices=devices, ranks=ranks,
                     rank=dist.get_rank())


def xor_all_gather(folded: Dict[int, torch.Tensor], spanning: List[int],
                   shape: Tuple[int, int]) -> Dict[int, torch.Tensor]:
    """The XOR over every rank of the partial products of the column
    blocks in ``spanning`` (those whose 'shard' positions lie in more
    than one process; the same list on every rank): ``folded`` holds
    this rank's fold of the blocks it has positions in. One all_gather
    of a (len(spanning), rows, width) buffer (zeros where this rank has
    nothing), folded on the buffer's device; a block held whole by one
    process is not sent. On gloo a buffer on a card is staged through
    pinned host memory explicitly (the products stay on the card;
    gloo's collectives take host tensors)."""
    import torch.distributed as dist
    device = next(iter(folded.values())).device if folded else _LOCAL[0]
    buf = torch.zeros((len(spanning), *shape), dtype=torch.uint8,
                      device=device)
    for slot, i in enumerate(spanning):
        if i in folded:
            buf[slot].copy_(folded[i])
    staged = dist.get_backend() == "gloo" and device.type == "cuda"
    if staged:
        send = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
        send.copy_(buf)
    else:
        send = buf
    gathered = [torch.empty_like(send) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, send)
    acc = gathered[0]
    for g in gathered[1:]:
        acc.bitwise_xor_(g)
    if staged:
        acc = acc.to(device)
    return {i: acc[slot] for slot, i in enumerate(spanning)}


def _global(mesh, spec, value: np.ndarray):
    """The same seeded host value on every process, each taking its own
    positions' slices of it as ``spec`` lays them out."""
    from .sharded_ec import place
    return place(mesh, spec, value)


def multihost_ec_step(k: int = 10, m: int = 4, n_per_device: int = 512,
                      outputs: Optional[dict] = None) -> dict:
    """The distributed EC step (encode, drop m shards, XOR-folded
    rebuild) on the global mesh, inputs assembled per process and outputs
    checked per process against the numpy oracle. Returns a summary
    (with this process's K1 launches and device); ``outputs``, when
    given, receives the ShardedArrays ``parity`` and ``rebuilt``."""
    import torch.distributed as dist
    from ..ops.codec import NumpyCodec
    from ..ops.device_stats import DEVICE_STATS, K1
    from .sharded_ec import (_pad_rows, decode_coeffs, encode_in_specs,
                             sharded_encode_fn, sharded_rebuild_fn,
                             survivor_spec)

    mesh = global_mesh()
    n = n_per_device * mesh.shape["data"]
    rank = dist.get_rank()

    # identical on every process: the logical payload
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (k, n), dtype=np.uint8)
    oracle = NumpyCodec(k, m).encode(data)

    def check_local(arr, want: np.ndarray, label: str) -> int:
        """Compare only this process's blocks."""
        for s in arr.shards:
            if not np.array_equal(s.data.cpu().numpy(),
                                  want[s.rows, s.cols]):
                raise AssertionError(
                    f"{label}: process {rank} block {s.index} diverged "
                    f"from the oracle")
        return len(arr.shards)

    enc_fn, coeffs = sharded_encode_fn(mesh, k, m, n)
    _, data_spec = encode_in_specs(mesh, m)
    parity = enc_fn(coeffs, _global(mesh, data_spec, data))
    parity_checked = check_local(parity, oracle, "multihost encode")

    survivors = list(range(k - m)) + list(range(k, k + m))
    missing = list(range(k - m, k))
    reb_fn = sharded_rebuild_fn(mesh, k, len(missing), n)
    surv = np.concatenate([data[: k - m], oracle], axis=0)
    rebuilt = reb_fn(decode_coeffs(k, m, survivors, missing),
                     _global(mesh, survivor_spec,
                             _pad_rows(surv, mesh.shape["shard"])))
    rebuilt_checked = check_local(rebuilt, data[k - m: k],
                                  "multihost rebuild")
    if outputs is not None:
        outputs.update(parity=parity, rebuilt=rebuilt)
    dev = _LOCAL[0]
    return {
        "process_index": rank,
        "process_count": dist.get_world_size(),
        "global_devices": mesh.size,
        "local_devices": len(_LOCAL),
        "mesh_shape": dict(mesh.shape),
        "parity_shards_checked": parity_checked,
        "rebuilt_shards_checked": rebuilt_checked,
        "backend": dist.get_backend(),
        "device_kind": torch.cuda.get_device_name(dev)
        if dev.type == "cuda" else "cpu",
        "k1_launches": DEVICE_STATS.launch_count(K1),
        "ok": True,
    }
