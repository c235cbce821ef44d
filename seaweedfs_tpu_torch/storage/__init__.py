"""storage — a volume server's disk formats and volumes: the superblock,
the needle record (``needle``, checksummed by ``crc``), the needle index
(``needle_map``), the append-only ``volume.Volume`` with its vacuum, and
``store.Store``, a server's volumes and EC shards and the rebuilder's
network repair routing."""

from .needle_map import MemDb  # noqa: F401
from .super_block import SUPER_BLOCK_SIZE, SuperBlock  # noqa: F401
from .types import entry_size, entry_to_bytes  # noqa: F401
