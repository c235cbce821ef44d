"""Asynchronous replication: the JAX package's ``replication/``
(reference weed/replication/). An ``EventSubscriber`` follows a filer's
``/filer/events``; the ``Replicator`` turns each create, update, rename
or delete under the watched prefix into calls on a sink (another filer,
an S3 bucket, GCS or B2 through their S3 interfaces, an Azure container
through SharedKey REST); a ``FilerSource`` reads the entry's bytes from
the source cluster's volume servers, so a chunk on a lost shard is
reconstructed by its holder.
"""

from .replicator import Replicator  # noqa: F401
from .sink import (AzureSink, B2Sink, FilerSink, GcsSink,  # noqa: F401
                   ReplicationSink, SinkError, make_sink)
from .source import FilerSource  # noqa: F401
from .sub import EventSubscriber  # noqa: F401
