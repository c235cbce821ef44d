"""ec — the erasure-coding pipeline: RS(10,4) striping of volumes into 14
shard files with the two-level block layout (1GB large rows, 1MB small
rows), and rebuild of lost shards, with the GF(2^8) compute routed
through ops.get_codec.
"""

from .constants import (  # noqa: F401
    DATA_SHARDS, LARGE_BLOCK_SIZE, PARITY_SHARDS, SMALL_BLOCK_SIZE,
    TOTAL_SHARDS, to_ext,
)
from .encoder import (rebuild_ec_files, write_ec_files,  # noqa: F401
                      write_sorted_file_from_idx)
