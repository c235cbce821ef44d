"""The publisher registry (``make_publisher``, ``publisher_from_config``)
and the publishers that need no module of their own; the JAX package's
``notification/queues.py``."""

from __future__ import annotations

import sys
import threading
from typing import Callable, Dict, List, Type
from ..util import config


class Publisher:
    name = "abstract"

    def initialize(self, **options):
        pass

    def send(self, key: str, event: dict) -> None:
        raise NotImplementedError

    def close(self):
        pass


PUBLISHERS: Dict[str, Type[Publisher]] = {}


def register(cls: Type[Publisher]) -> Type[Publisher]:
    PUBLISHERS[cls.name] = cls
    return cls


def make_publisher(name: str, **options) -> Publisher:
    cls = PUBLISHERS.get(name)
    if cls is None:
        raise ValueError(f"unknown notification backend {name!r}; "
                         f"have {sorted(PUBLISHERS)}")
    p = cls()
    p.initialize(**options)
    return p


@register
class LogPublisher(Publisher):
    """Reference notification/log/log_queue.go — print each event."""

    name = "log"

    def initialize(self, stream=None, **options):
        self._stream = stream or sys.stderr

    def send(self, key: str, event: dict) -> None:
        print(f"[notify] {key}: {event}", file=self._stream)


@register
class MemoryPublisher(Publisher):
    """In-process pub-sub used by tests and the local replicator."""

    name = "memory"

    def initialize(self, **options):
        self._subs: List[Callable[[str, dict], None]] = []
        self._lock = threading.Lock()
        self.events: List[tuple] = []

    def subscribe(self, fn: Callable[[str, dict], None]):
        with self._lock:
            self._subs.append(fn)

    def send(self, key: str, event: dict) -> None:
        with self._lock:
            self.events.append((key, event))
            subs = list(self._subs)
        for fn in subs:
            fn(key, event)


def _post_with_retries(url: str, body: bytes, headers: dict,
                       timeout: float, retries: int, label: str) -> None:
    """Shared external-POST discipline for HTTP-backed publishers:
    retry with capped exponential backoff; 4xx (bar 429) short-circuits
    — it can never succeed on retry."""
    import time as _time
    from ..server.http_util import HttpError, http_call
    last = None
    for attempt in range(retries):
        try:
            return http_call("POST", url, body, headers,
                             timeout=timeout, external=True)
        except HttpError as e:
            last = e
            if 400 <= e.status < 500 and e.status != 429:
                break
        except Exception as e:  # noqa: BLE001 - network: retried
            last = e
        if attempt + 1 < retries:
            _time.sleep(config.retry_backoff_s(
                min(0.2 * (2 ** attempt), 2.0)))
    # chain the last HttpError so callers can classify by status
    # (google_pub_sub re-auths on 401)
    raise RuntimeError(f"{label} {url} failed after "
                       f"{attempt + 1} attempts: {last}") from last


@register
class WebhookPublisher(Publisher):
    """POST each metadata event as JSON to an HTTP endpoint — the
    broker-neutral external integration (any Kafka/SQS bridge, serverless
    consumer, or audit collector can sit behind a URL). Plays the role of
    the reference's external notification backends
    (weed/notification/) without requiring their cloud SDKs.

    Options: url (required), timeout (s), retries (attempts per event),
    hmac_key (optional — adds an X-Seaweed-Signature hex-HMAC-SHA256 of
    the body so the receiver can authenticate the sender).
    """

    name = "webhook"

    def initialize(self, url: str = "", timeout: float = 10.0,
                   retries: int = 3, hmac_key: str = "", **options):
        if not url:
            raise ValueError("webhook publisher needs a url")
        self.url = url
        self.timeout = float(timeout)
        self.retries = max(1, int(retries))
        self.hmac_key = hmac_key

    def send(self, key: str, event: dict) -> None:
        import hashlib
        import hmac
        import json
        body = json.dumps({"key": key, "event": event}).encode()
        headers = {"Content-Type": "application/json"}
        if self.hmac_key:
            headers["X-Seaweed-Signature"] = hmac.new(
                self.hmac_key.encode(), body, hashlib.sha256).hexdigest()
        _post_with_retries(self.url, body, headers, self.timeout,
                           self.retries, "webhook")


@register
class KafkaPublisher(Publisher):
    """Publish events to a Kafka topic over the classic binary protocol —
    a from-scratch produce client (notification/kafka.py), no SDK.
    Mirrors reference weed/notification/kafka/kafka_queue.go (sarama):
    event key = file path (so per-path ordering holds within a
    partition), value = JSON event."""

    name = "kafka"

    def initialize(self, hosts: str = "", topic: str = "seaweedfs_filer",
                   timeout: float = 10.0, retries: int = 3, **options):
        if not hosts:
            raise ValueError("kafka publisher needs hosts (host:port[,..])")
        from .kafka import KafkaProducer
        self.topic = topic
        self._producer = KafkaProducer(hosts, timeout=timeout,
                                       retries=retries)

    def send(self, key: str, event: dict) -> None:
        import json
        self._producer.send(self.topic, key.encode(),
                            json.dumps({"key": key, "event": event},
                                       sort_keys=True).encode())

    def close(self):
        self._producer.close()


@register
class SqsPublisher(Publisher):
    """Publish events to an AWS SQS queue via the query API with SigV4
    signing (reference weed/notification/aws_sqs/sqs_queue.go via the
    AWS SDK; same SendMessage wire call, signed by our own s3/auth
    primitives with service='sqs')."""

    name = "aws_sqs"

    def initialize(self, queue_url: str = "", access_key: str = "",
                   secret_key: str = "", region: str = "us-east-1",
                   timeout: float = 10.0, retries: int = 3, **options):
        if not queue_url:
            raise ValueError("aws_sqs publisher needs queue_url")
        self.queue_url = queue_url
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.timeout = float(timeout)
        self.retries = max(1, int(retries))

    def send(self, key: str, event: dict) -> None:
        import datetime
        import hashlib
        import json
        import urllib.parse
        from ..s3.auth import authorization_header_v4
        body = urllib.parse.urlencode({
            "Action": "SendMessage",
            "MessageBody": json.dumps({"key": key, "event": event},
                                      sort_keys=True),
            "Version": "2012-11-05",
        }).encode()
        parsed = urllib.parse.urlparse(self.queue_url)
        now = datetime.datetime.now(datetime.timezone.utc)
        headers = {
            "content-type": "application/x-www-form-urlencoded",
            "host": parsed.netloc,
            "x-amz-content-sha256": hashlib.sha256(body).hexdigest(),
            "x-amz-date": now.strftime("%Y%m%dT%H%M%SZ"),
        }
        headers["Authorization"] = authorization_header_v4(
            "POST", parsed.path or "/", headers,
            headers["x-amz-content-sha256"], self.access_key,
            self.secret_key, self.region, "sqs")
        _post_with_retries(self.queue_url, body, headers, self.timeout,
                           self.retries, "sqs")


@register
class GocdkPubSubPublisher(Publisher):
    """URL-dispatching meta-publisher — the reference's gocdk_pub_sub
    slot (weed/notification/gocdk_pub_sub/gocdk_pub_sub.go): one
    `topic_url` whose scheme selects the broker, like the Go CDK's
    `pubsub.OpenTopic`. Every scheme routes to a native from-scratch
    publisher in this package (no SDKs):

    - ``kafka://my-topic`` — brokers from the `hosts` option or the Go
      CDK's `KAFKA_BROKERS` env var;
    - ``awssqs://sqs.<region>.amazonaws.com/<acct>/<queue>[?region=..]``;
    - ``gcppubsub://projects/<project>/topics/<topic>`` (or the
      shorthand ``gcppubsub://<project>/<topic>``);
    - ``mem://<topic>`` — the in-process memory publisher;
    - ``http(s)://...`` — the webhook publisher (an extension: the Go
      CDK has no HTTP driver, but a URL-shaped catch-all belongs here).

    Schemes the Go CDK supports with no wire analog in this
    environment (rabbit, nats, azuresb) fail loudly at initialize.
    Remaining options pass through to the wrapped publisher
    (credentials, timeouts, retries).
    """

    name = "gocdk_pub_sub"

    def initialize(self, topic_url: str = "", **options):
        import os
        import urllib.parse
        if not topic_url:
            raise ValueError("gocdk_pub_sub needs a topic_url")
        parsed = urllib.parse.urlsplit(topic_url)
        scheme = parsed.scheme.lower()
        query = dict(urllib.parse.parse_qsl(parsed.query))
        # the URL always wins over a same-named option (otherwise the
        # wrapped make_publisher gets the kwarg twice and TypeErrors)
        if scheme == "kafka":
            hosts = options.pop("hosts", "") \
                or os.environ.get("KAFKA_BROKERS", "")
            if not hosts:
                raise ValueError(
                    "gocdk_pub_sub kafka:// needs brokers via the "
                    "'hosts' option or KAFKA_BROKERS")
            topic = (parsed.netloc + parsed.path).strip("/")
            options.pop("topic", None)
            self._inner = make_publisher("kafka", hosts=hosts,
                                         topic=topic, **options)
        elif scheme == "awssqs":
            opt_region = options.pop("region", "")
            region = query.get("region", "") or opt_region
            if not region:
                host_parts = parsed.netloc.split(".")
                if len(host_parts) >= 2 and host_parts[0] == "sqs":
                    region = host_parts[1]
            if not region:
                raise ValueError(
                    "gocdk_pub_sub awssqs:// needs ?region= (host is "
                    f"not sqs.<region>...: {parsed.netloc!r})")
            queue_url = f"https://{parsed.netloc}{parsed.path}"
            options.pop("queue_url", None)
            self._inner = make_publisher("aws_sqs", queue_url=queue_url,
                                         region=region, **options)
        elif scheme == "gcppubsub":
            parts = [p for p in
                     (parsed.netloc + parsed.path).split("/") if p]
            if len(parts) == 4 and parts[0] == "projects" \
                    and parts[2] == "topics":
                project, topic = parts[1], parts[3]
            elif len(parts) == 2:
                project, topic = parts
            else:
                raise ValueError(
                    "gocdk_pub_sub gcppubsub:// wants "
                    "projects/<project>/topics/<topic>, got "
                    f"{topic_url!r}")
            options.pop("project_id", None)
            options.pop("topic", None)
            self._inner = make_publisher("google_pub_sub",
                                         project_id=project,
                                         topic=topic, **options)
        elif scheme == "mem":
            self._inner = make_publisher("memory")
        elif scheme in ("http", "https"):
            options.pop("url", None)
            self._inner = make_publisher("webhook", url=topic_url,
                                         **options)
        else:
            raise ValueError(
                f"gocdk_pub_sub: no driver for scheme {scheme!r} "
                "(have kafka, awssqs, gcppubsub, mem, http/https; "
                "rabbit/nats/azuresb have no broker analog here)")
        self.topic_url = topic_url

    def send(self, key: str, event: dict) -> None:
        self._inner.send(key, event)

    def close(self):
        self._inner.close()


def publisher_from_config(cfg: dict):
    """Build the enabled publisher from a flattened notification config
    (util.config.load_config("notification")) — the reference filer's
    notification.LoadConfiguration over notification.toml: the section
    with `enabled = true` wins, its remaining keys become the
    publisher's options. Returns None when nothing is enabled; more
    than one enabled section is a config conflict and fails loudly
    (a flattened dict has no file order to break the tie with, and
    silently picking one would publish to the wrong broker).

    Env-sourced keys arrive with dots where TOML has underscores
    (WEED_NOTIFICATION_AWS_SQS_QUEUE_URL ->
    "notification.aws.sqs.queue.url"), so both spellings of the section
    name and of option keys are accepted.
    """
    def truthy(v) -> bool:
        if isinstance(v, str):
            return v.strip().lower() in ("1", "true", "yes", "on")
        return bool(v)

    enabled_names = []
    for name in sorted(PUBLISHERS):
        prefixes = {f"notification.{name}.",
                    f"notification.{name.replace('_', '.')}."}
        if any(truthy(cfg.get(p + "enabled")) for p in prefixes):
            enabled_names.append((name, prefixes))
    if not enabled_names:
        return None
    if len(enabled_names) > 1:
        raise ValueError(
            "notification config enables more than one backend: "
            + ", ".join(n for n, _ in enabled_names)
            + " — enable exactly one (check WEED_NOTIFICATION_* env "
            "vars too)")
    name, prefixes = enabled_names[0]
    options = {}
    for key, value in cfg.items():
        for p in prefixes:
            if key.startswith(p):
                opt = key[len(p):].replace(".", "_")
                if opt != "enabled":
                    options[opt] = value
                break
    return make_publisher(name, **options)
