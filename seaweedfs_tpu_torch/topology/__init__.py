"""topology — the master's cluster state and placement: the DataCenter →
Rack → DataNode tree with each node's volume slots, a writable-volume
layout per (collection, replication, ttl), replica placement and volume
growth, the EC shard map, and the file-key sequencer. The JAX package's
``topology/`` without raft and its sequencers."""

from .node import DataCenter, DataNode, Rack, VolumeInfo  # noqa: F401
from .topology import Sequencer, Topology  # noqa: F401
from .volume_growth import (NoFreeSlots, VolumeGrowth,  # noqa: F401
                            find_empty_slots)
from .volume_layout import VolumeLayout  # noqa: F401
