"""ec — the erasure-coding pipeline: RS(10,4) striping of volumes into 14
shard files with the two-level block layout (1GB large rows, 1MB small
rows), the streaming spread of an encode's shards to their holders
(ec.spread), rebuild of lost shards (from local shard files or streamed from an
ec.gather source), single-lost-shard trace and plane repair, decode back
to a volume, needle reads of a mounted EC volume (EcVolume) with
reconstruct-on-read of a lost shard (DegradedReadEngine), and the
syndrome scrub (ScrubEngine), with the GF(2^8) compute routed through
ops.get_codec.
"""

from .constants import (  # noqa: F401
    DATA_SHARDS, LARGE_BLOCK_SIZE, PARITY_SHARDS, SMALL_BLOCK_SIZE,
    TOTAL_SHARDS, to_ext,
)
from .decoder import (find_dat_file_size,  # noqa: F401
                      rebuild_ec_file_piggyback, rebuild_ec_file_repair,
                      write_dat_file, write_idx_file_from_ec_index)
from .encoder import (ec_shard_base_size,  # noqa: F401
                      rebuild_ec_files, rebuild_ec_files_streaming,
                      rebuild_ec_files_streaming_piggyback, write_ec_files,
                      write_ec_files_spread, write_sorted_file_from_idx)
from .gather import (GatherStats, LocalPlaneReader,  # noqa: F401
                     LocalRepairReader, LocalShardReader, PlaneGatherSource,
                     RepairGatherSource, StripedGatherSource)
from .degraded import DegradedReadEngine, SlabCache  # noqa: F401
from .ec_volume import (EcShardNotFound, EcVolume,  # noqa: F401
                        EcVolumeShard)
from .locate import Interval, locate_data  # noqa: F401
from .scrub import ScrubEngine, locate_corrupt_shard  # noqa: F401
from .shard_cache import EcShardLocationCache  # noqa: F401
