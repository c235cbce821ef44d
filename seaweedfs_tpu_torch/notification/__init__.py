"""Metadata-event publishers: the JAX package's ``notification/``
(reference weed/notification/). A filer hands each change of an entry
to the publisher that ``notification.toml`` (or ``WEED_NOTIFICATION_*``)
enables: ``log`` (stderr or a stream), ``memory`` (in process),
``webhook`` (a JSON POST, HMAC-signed on request), ``kafka`` (the wire
protocol, ``kafka.py``), ``aws_sqs`` (a SigV4-signed SendMessage),
``google_pub_sub`` (a service-account JWT, RS256 and the REST publish,
``google_pub_sub.py``) and ``gocdk_pub_sub`` (one topic URL whose scheme
picks one of these). No SDK: every wire call is made here.
"""

from .google_pub_sub import GooglePubSubPublisher  # noqa: F401
from .queues import (  # noqa: F401
    PUBLISHERS,
    GocdkPubSubPublisher,
    KafkaPublisher,
    LogPublisher,
    MemoryPublisher,
    Publisher,
    SqsPublisher,
    WebhookPublisher,
    make_publisher,
)
