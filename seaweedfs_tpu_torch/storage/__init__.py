"""storage — the on-disk formats the EC encoder and decoder read:
superblock, needle index, and needle record sizes; and ``store.Store``,
a volume server's EC shards and the rebuilder's network repair
routing."""

from .needle_map import MemDb  # noqa: F401
from .super_block import SUPER_BLOCK_SIZE, SuperBlock  # noqa: F401
from .types import entry_size, entry_to_bytes  # noqa: F401
