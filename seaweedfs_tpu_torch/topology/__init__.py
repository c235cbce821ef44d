"""topology — the master's cluster state and placement: the DataCenter →
Rack → DataNode tree with each node's volume slots, a writable-volume
layout per (collection, replication, ttl), replica placement and volume
growth, the EC shard map, the file-key sequencers, and raft among the
masters. The JAX package's ``topology/``."""

from .node import DataCenter, DataNode, Rack, VolumeInfo  # noqa: F401
from .raft import NotLeaderError, RaftNode  # noqa: F401
from .topology import (EtcdSequencer, RaftSequencer,  # noqa: F401
                       Sequencer, Topology)
from .volume_growth import (NoFreeSlots, VolumeGrowth,  # noqa: F401
                            find_empty_slots)
from .volume_layout import VolumeLayout  # noqa: F401
