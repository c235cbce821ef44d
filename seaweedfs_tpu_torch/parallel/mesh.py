"""Mesh of device positions for the multi-device EC programs.

The JAX package builds a ``jax.sharding.Mesh`` over ``jax.devices()``.
Here a mesh is an array of *positions*, each a ``torch.device``: two
positions may name one card (the positions then share it, as a test's
eight CPU positions share the CPU), and a multi-process mesh records
which rank holds each position. The programs of ``sharded_ec`` and
``mesh_codec`` split their work by position; every position runs K1.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

#: Positions a codec mesh puts on its 'data' axis (0: all); the JAX
#: package's SW_EC_MESH_WIDTH_DEVICES default. The port reads no
#: environment.
MESH_WIDTH_DEVICES = 0


class Mesh:
    """``devices``: an object array of ``torch.device``, one per position,
    in the mesh's shape; ``ranks``: the same shape, the process holding
    each position (all 0 in one process). ``shape`` is a dict by axis
    name, as JAX's ``Mesh.shape`` reads."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 ranks: Optional[np.ndarray] = None, rank: int = 0):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{devices.ndim}-d mesh")
        self.ranks = np.zeros(devices.shape, dtype=np.int64) \
            if ranks is None else np.asarray(ranks).reshape(devices.shape)
        self.rank = int(rank)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def device(self, index: Tuple[int, ...]) -> torch.device:
        return self.devices[index]

    def is_local(self, index: Tuple[int, ...]) -> bool:
        """Whether this process holds the position."""
        return int(self.ranks[index]) == self.rank

    def label(self, index: Tuple[int, ...]) -> str:
        """The position's name: its device and its flat index
        (``cuda:0/1``), unique even where positions share a card."""
        flat = int(np.ravel_multi_index(index, self.devices.shape))
        return f"{self.devices[index]}/{flat}"

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _cards() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass the mesh's "
                           "positions (devices=[...]) to build one on the "
                           "CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data", "shard"),
              devices=None, ranks=None, rank: int = 0) -> Mesh:
    """A mesh over ``devices`` (every card by default; without one it
    raises). Default layout: ``(n/2, 2)`` for an even n > 1, else
    ``(n, 1)`` — encode spreads over 'data'; 'shard' splits the rebuild's
    contraction and the parity rows. ``ranks`` (one per device) and
    ``rank`` are for a mesh across processes (parallel/multihost)."""
    devices = _cards() if devices is None else \
        [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n // 2, 2) if n % 2 == 0 and n > 1 else (n, 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names[: len(shape)],
                None if ranks is None else np.asarray(ranks).reshape(shape),
                rank)


def make_codec_mesh(devices=None,
                    width_devices: int = MESH_WIDTH_DEVICES) -> Mesh:
    """The mesh of a MeshCodec: every position on 'data' (the width axis,
    the only one a codec product splits over), at most ``width_devices``
    of them (0: all)."""
    devices = _cards() if devices is None else list(devices)
    cap = int(width_devices)
    width = len(devices) if cap <= 0 else min(cap, len(devices))
    return make_mesh(shape=(width, 1), axis_names=("data", "shard"),
                     devices=devices[:width])
