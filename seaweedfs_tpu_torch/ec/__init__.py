"""ec — the erasure-coding pipeline: RS(10,4) striping of volumes into 14
shard files with the two-level block layout (1GB large rows, 1MB small
rows), the streaming spread of an encode's shards to their holders
(ec.spread), rebuild of lost shards (from local shard files or streamed from an
ec.gather source), single-lost-shard trace and plane repair, decode back
to a volume, needle reads of a mounted EC volume (EcVolume) with
reconstruct-on-read of a lost shard (DegradedReadEngine), and the
syndrome scrub (ScrubEngine), with the GF(2^8) compute routed through
ops.get_codec.

Only the constants load with the package; every other name loads its
module (and so torch) at its first use, so that a process that needs
the shard geometry alone (the shell, a client) starts without torch.
"""

from .constants import (  # noqa: F401
    DATA_SHARDS, LARGE_BLOCK_SIZE, PARITY_SHARDS, SMALL_BLOCK_SIZE,
    TOTAL_SHARDS, to_ext,
)

_LAZY = {name: module for module, names in (
    ("decoder", ("find_dat_file_size", "rebuild_ec_file_piggyback",
                 "rebuild_ec_file_repair", "write_dat_file",
                 "write_idx_file_from_ec_index")),
    ("encoder", ("ec_shard_base_size", "rebuild_ec_files",
                 "rebuild_ec_files_streaming",
                 "rebuild_ec_files_streaming_piggyback", "write_ec_files",
                 "write_ec_files_spread", "write_sorted_file_from_idx")),
    ("gather", ("GatherStats", "LocalPlaneReader", "LocalRepairReader",
                "LocalShardReader", "PlaneGatherSource",
                "RepairGatherSource", "StripedGatherSource")),
    ("degraded", ("DegradedReadEngine", "SlabCache")),
    ("ec_volume", ("EcShardNotFound", "EcVolume", "EcVolumeShard")),
    ("locate", ("Interval", "locate_data")),
    ("scrub", ("ScrubEngine", "locate_corrupt_shard")),
    ("shard_cache", ("EcShardLocationCache",)),
) for name in names}


def __getattr__(name):
    """A name of ``_LAZY`` from its module, or a submodule, at first
    use."""
    from importlib import import_module
    from importlib.util import find_spec
    module = _LAZY.get(name)
    if module is not None:
        value = getattr(import_module(f".{module}", __name__), name)
    elif not name.startswith("_") and find_spec(f"{__name__}.{name}"):
        value = import_module(f".{name}", __name__)
    else:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    globals()[name] = value
    return value
