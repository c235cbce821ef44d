"""The port's notification publishers against the JAX package's, on the
CPU.

- Kafka: both packages' ``KafkaProducer`` talk to fresh copies of the
  JAX tests' ``FakeBroker`` (``tests/test_notification.py``) under one
  fixed clock; every request frame on the wire (ApiVersions, Metadata,
  Produce with its message set or CRC32-C record batch), what the broker
  stored, the offsets returned and every raised error (class and text,
  the broker's port taken out) must be equal, for a broker of every
  version range, the v0 fallback of a broker that severs the probe,
  retries on a lost leader, exhausted retries, a permanent broker error,
  no version overlap, ``acks=0``, a leaderless keyed partition and a bad
  bootstrap list.
- Webhook, SQS and Pub/Sub: every request both packages send (method,
  URL, headers, body) is captured at ``urllib.request.urlopen``; the
  webhook body and its HMAC, retries and the 4xx short cut, the SigV4
  SendMessage, the service account's JWT assertion (RS256 over the fixed
  clock, checked by the JAX ``FakePubSub``), the publish body and the
  re-authentication after a 401 must be equal.
- ``make_publisher``, ``gocdk_pub_sub``'s dispatch and
  ``publisher_from_config`` on the same sections and environment
  spellings, including their refusals, must agree.

Tolerances: none (bytes and text compared exactly).
"""

import datetime
import io
import json
import os
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import seaweedfs_tpu.notification.kafka as ref_kafka
import seaweedfs_tpu.notification.queues as ref_queues
import seaweedfs_tpu_torch.notification.kafka as port_kafka
import seaweedfs_tpu_torch.notification.queues as port_queues
from seaweedfs_tpu.notification import google_pub_sub as ref_gps
from seaweedfs_tpu_torch.notification import google_pub_sub as port_gps
from test_notification import FakeBroker, FakePubSub, _make_service_account

NOW = 1_760_000_000.25
PKGS = {"ref": (ref_queues, ref_kafka, ref_gps),
        "port": (port_queues, port_kafka, port_gps)}


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)

    class FixedDateTime(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return datetime.datetime.fromtimestamp(NOW, tz)
    monkeypatch.setattr(datetime, "datetime", FixedDateTime)


class RecordingBroker(FakeBroker):
    """``FakeBroker`` that keeps every frame a client sends, in order."""

    def __init__(self, *a, **kw):
        self.wire = []
        super().__init__(*a, **kw)

    def _recv(self, conn, n):
        data = FakeBroker._recv(conn, n)
        if data is not None:
            self.wire.append(data)
        return data


def _outcome(fn, port_str):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - compared across packages
        return (type(e).__name__, str(e).replace(port_str, "PORT"))


def _kafka_case(kafka, broker_kw, script, producer_kw=None,
                broker_cls=RecordingBroker, prepare=None):
    broker = broker_cls(**broker_kw)
    results = []
    try:
        prod = None

        def make():
            nonlocal prod
            prod = kafka.KafkaProducer(f"127.0.0.1:{broker.port}",
                                       timeout=5, **(producer_kw or {}))
            return None
        results.append(_outcome(make, str(broker.port)))
        if prepare is not None:
            prepare(broker)
        for step in script:
            results.append(_outcome(lambda: step(prod), str(broker.port)))
        deadline = time.monotonic() + 5
        want = sum(1 for r in results if r == ("ok", -1))
        while want and len(broker.produced) < want and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        prod.close()
    finally:
        broker.stop()
    return {"results": results, "produced": broker.produced,
            "wire": broker.wire, "violations": broker.version_violations,
            "fail_first": broker.fail_first}


def _send(topic, key, value):
    return lambda prod: prod.send(topic, key, value)


KAFKA_CASES = {
    "any_version": (dict(topic="events", partitions=3),
                    [_send("events", b"/a/b", b'{"x":1}'),
                     _send("events", b"/a/b", b'{"x":2}'),
                     _send("events", b"/c", b"v")], {}),
    "v3_only": (dict(topic="events", partitions=2, produce_range=(3, 11),
                     metadata_range=(4, 12)),
                [_send("events", b"/a/b", b'{"x":1}'),
                 _send("events", b"/a/b", b'{"x":2}')], {}),
    "v0_only": (dict(topic="events", partitions=1, produce_range=(0, 2),
                     metadata_range=(0, 3)),
                [_send("events", b"k", b"v")], {}),
    "not_leader_retry": (dict(topic="events", partitions=1, fail_first=1),
                         [_send("events", b"k", b"v")], {"retries": 3}),
    "exhausted": (dict(topic="events", partitions=1, fail_first=99),
                  [_send("events", b"k", b"v")], {"retries": 2}),
    "no_overlap": (dict(topic="events", partitions=1,
                        produce_range=(12, 13), metadata_range=(4, 12)),
                   [_send("events", b"k", b"v")], {"retries": 5}),
    "acks0": (dict(topic="events", partitions=1),
              [_send("events", b"k", b"v1"), _send("events", b"k", b"v2")],
              {"acks": 0}),
    "unknown_topic": (dict(topic="events", partitions=1),
                      [_send("other", b"k", b"v")], {"retries": 2}),
}


@pytest.mark.parametrize("case", sorted(KAFKA_CASES))
def test_kafka_wire_matches_jax(fixed_clock, case):
    broker_kw, script, producer_kw = KAFKA_CASES[case]
    got = {name: _kafka_case(pkg[1], broker_kw, script, producer_kw)
           for name, pkg in PKGS.items()}
    assert got["port"] == got["ref"]
    assert got["ref"]["wire"]


def test_kafka_permanent_error_and_leaderless_match_jax(fixed_clock):
    def permanent(broker):
        orig = FakeBroker._produce

        def produce(self, r, ver=0):
            body = orig(self, r, ver)
            return body[:-14] + ref_kafka.struct.pack(">ihq", 0, 10, 0)
        broker._produce = produce.__get__(broker)

    def leaderless(prod):
        key = b"/some/path"
        prod.send("events", key, b"v")
        want = __import__("zlib").crc32(key) % 3
        prod._leaders["events"] = {p: a for p, a in
                                   prod._leaders["events"].items()
                                   if p != want}
        return prod._send_once("events", key, b"v2")

    for kw, script, pkw, prep in (
            (dict(topic="events", partitions=1, fail_first=99,
                  produce_range=(0, 0)),
             [_send("events", b"k", b"v")], {"retries": 5}, permanent),
            (dict(topic="events", partitions=3), [leaderless], {}, None)):
        got = {name: _kafka_case(pkg[1], kw, script, pkw, prepare=prep)
               for name, pkg in PKGS.items()}
        assert got["port"] == got["ref"]
        assert got["ref"]["results"][-1][0] == "KafkaError"


def test_kafka_pre_kip35_fallback_matches_jax(fixed_clock):
    class AncientRecording(RecordingBroker):
        """The JAX test's AncientBroker: it severs on ApiVersions."""

        def _client(self, conn):
            raw = self._recv(conn, 4)
            if raw is None:
                return
            payload = self._recv(conn, ref_kafka.struct.unpack(">i", raw)[0])
            if ref_kafka._Reader(payload).i16() == ref_kafka.API_VERSIONS:
                conn.close()          # a broker from before KIP-35
                return
            try:
                while payload is not None:
                    r = ref_kafka._Reader(payload)
                    api, ver, corr = r.i16(), r.i16(), r.i32()
                    r.string()
                    body = self._metadata(ver) if \
                        api == ref_kafka.API_METADATA else self._produce(r, ver)
                    resp = ref_kafka.struct.pack(">i", corr) + body
                    conn.sendall(ref_kafka.struct.pack(">i", len(resp)) + resp)
                    raw = self._recv(conn, 4)
                    if raw is None:
                        return
                    payload = self._recv(
                        conn, ref_kafka.struct.unpack(">i", raw)[0])
            except OSError:
                pass
            finally:
                conn.close()

    kw = dict(topic="events", partitions=1, produce_range=(0, 0),
              metadata_range=(0, 0))
    got = {name: _kafka_case(pkg[1], kw, [_send("events", b"k", b"old")],
                             broker_cls=AncientRecording)
           for name, pkg in PKGS.items()}
    assert got["port"] == got["ref"]
    assert got["ref"]["produced"] == [(0, b"k", b"old")]


def test_kafka_codecs_and_bootstrap_match_jax():
    pairs = [(b"k%d" % i, b"v" * i) for i in range(5)] + [(None, b"x")]
    assert port_kafka.encode_message_set(pairs) == \
        ref_kafka.encode_message_set(pairs)
    assert port_kafka.encode_record_batch(pairs, 1_760_000_000_250) == \
        ref_kafka.encode_record_batch(pairs, 1_760_000_000_250)
    for n in (0, 1, -1, 63, -64, 300, -(1 << 40), 1 << 40):
        assert port_kafka._varint(n) == ref_kafka._varint(n)
        assert port_kafka.read_varint(port_kafka._varint(n), 0) == \
            ref_kafka.read_varint(ref_kafka._varint(n), 0)
    for data in (b"", b"123456789", bytes(range(256)) * 3):
        assert port_kafka._crc32c(data) == ref_kafka._crc32c(data)
    assert port_kafka._crc32c(b"123456789") == 0xE3069283
    for spec in ("", "hostonly", "h:x", ",", "a:1,b:2"):
        outs = []
        for kafka in (ref_kafka, port_kafka):
            try:
                outs.append(kafka.KafkaProducer(spec).seeds)
            except ValueError as e:
                outs.append(str(e))
        assert outs[0] == outs[1]


# -- the HTTP publishers -------------------------------------------------------

class Endpoint:
    """A local HTTP endpoint answering each POST with the next status of
    ``statuses`` (200 once they run out) and a JSON body."""

    def __init__(self, statuses=(), reply=b"{}"):
        self.statuses = list(statuses)
        self.reply = reply
        self.bodies = []
        ep = self

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                ep.bodies.append(self.rfile.read(n))
                code = ep.statuses.pop(0) if ep.statuses else 200
                self.send_response(code)
                self.send_header("Content-Length", str(len(ep.reply)))
                self.end_headers()
                self.wfile.write(ep.reply)

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        self._t = threading.Thread(target=self.httpd.serve_forever,
                                   daemon=True)
        self._t.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._t.join(5)


@pytest.fixture
def captured(monkeypatch):
    """Every request that reaches ``urllib.request.urlopen``."""
    seen = []
    real = urllib.request.urlopen

    def urlopen(req, *a, **kw):
        data = req.data
        seen.append((req.get_method(), req.full_url,
                     sorted((k.lower(), v) for k, v in req.header_items()),
                     data))
        return real(req, *a, **kw)
    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    return seen


def _publish(queues, name, sends, **options):
    out = []
    try:
        p = queues.make_publisher(name, **options)
    except Exception as e:  # noqa: BLE001 - compared across packages
        return [(type(e).__name__, str(e))]
    for key, event in sends:
        try:
            p.send(key, event)
            out.append("ok")
        except Exception as e:  # noqa: BLE001
            cause = e.__cause__
            out.append((type(e).__name__, str(e),
                        getattr(cause, "status", None)))
    p.close()
    return out


@pytest.mark.parametrize("statuses", [(), (500, 503), (500, 500, 500),
                                      (404,), (429, 200)])
def test_webhook_matches_jax(fixed_clock, captured, statuses):
    got = {}
    for name, pkg in PKGS.items():
        ep = Endpoint(statuses)
        captured.clear()
        try:
            res = _publish(pkg[0], "webhook",
                           [("/dir/a b", {"newEntry": {"path": "/dir/a b"},
                                          "n": [1, 2.5, None]})],
                           url=f"http://127.0.0.1:{ep.port}/hook?x=1",
                           retries=3, hmac_key="s3cret")
        finally:
            ep.stop()
        got[name] = [str(r).replace(str(ep.port), "PORT") for r in res], \
            [(m, u.replace(str(ep.port), "PORT"), h, d)
             for m, u, h, d in captured], ep.bodies
    assert got["port"] == got["ref"]
    reqs = got["ref"][1]
    assert reqs and any(k == "x-seaweed-signature" for k, _ in reqs[0][2])


def test_sqs_signed_request_matches_jax(fixed_clock, captured):
    ep = Endpoint()
    got = {}
    try:
        for name, pkg in PKGS.items():
            captured.clear()
            res = _publish(pkg[0], "aws_sqs",
                           [("/k", {"n": 1}), ("/d/é", {"x": "y"})],
                           queue_url=f"http://127.0.0.1:{ep.port}/123/q",
                           access_key="ak", secret_key="sk",
                           region="eu-west-1")
            got[name] = res, list(captured)
    finally:
        ep.stop()
    assert got["port"] == got["ref"]
    auth = dict(got["ref"][1][0][2])["authorization"]
    assert "/eu-west-1/sqs/aws4_request" in auth


def test_pubsub_assertion_and_publish_match_jax(tmp_path, fixed_clock,
                                                captured):
    sa_path, _, _ = _make_service_account(str(tmp_path))
    sa = json.load(open(sa_path))
    got = {}
    # one fake for both: the JWT's audience names its port
    fake = FakePubSub(sa["private_key"])
    try:
        for name, pkg in PKGS.items():
            fake.token = "fake-bearer-token-1"
            fake.published, fake.auth_failures = [], []
            captured.clear()
            opts = dict(google_application_credentials=sa_path,
                        topic="weed-events",
                        endpoint=f"http://127.0.0.1:{fake.port}",
                        token_uri=f"http://127.0.0.1:{fake.port}/token")
            p = pkg[0].make_publisher("google_pub_sub", **opts)
            p.send("/dir/file1", {"newEntry": {"name": "file1"}})
            fake.token = "rotated-token-2"        # revoked: one 401
            p.send("/dir/file2", {"deleted": True})
            got[name] = (list(captured), fake.published,
                         fake.auth_failures, p._jwt_assertion(NOW))
    finally:
        fake.stop()
    assert got["port"] == got["ref"]
    assert got["ref"][2] == ["bad bearer"]
    assert [k for _, k, _ in got["ref"][1]] == ["/dir/file1", "/dir/file2"]
    key = port_gps.RsaPrivateKey.from_pem(sa["private_key"])
    rkey = ref_gps.RsaPrivateKey.from_pem(sa["private_key"])
    assert (key.n, key.e, key.d) == (rkey.n, rkey.e, rkey.d)
    assert port_gps.rs256_sign(key, b"abc") == ref_gps.rs256_sign(rkey, b"abc")


def test_pubsub_wrong_key_refused_alike(tmp_path, fixed_clock):
    sa_path, _, _ = _make_service_account(str(tmp_path))
    os.makedirs(tmp_path / "o")
    other, _, _ = _make_service_account(str(tmp_path / "o"))
    sa = json.load(open(sa_path))
    got = {}
    fake = FakePubSub(sa["private_key"])
    try:
        for name, pkg in PKGS.items():
            fake.published, fake.auth_failures = [], []
            res = _publish(pkg[0], "google_pub_sub", [("/k", {})],
                           google_application_credentials=other,
                           project_id="proj-1", topic="t",
                           endpoint=f"http://127.0.0.1:{fake.port}",
                           token_uri=f"http://127.0.0.1:{fake.port}/token")
            got[name] = res, fake.auth_failures, fake.published
    finally:
        fake.stop()
    assert got["port"] == got["ref"]
    assert "bad signature" in got["ref"][1]


# -- the registry, gocdk_pub_sub and publisher_from_config ---------------------

def _describe(p):
    if isinstance(p, tuple):
        return p
    inner = getattr(p, "_inner", None)
    keys = ("name", "url", "hmac_key", "retries", "timeout", "queue_url",
            "region", "access_key", "topic", "topic_url", "project_id")
    d = {k: getattr(p, k) for k in keys if hasattr(p, k)}
    if inner is not None:
        d["inner"] = _describe(inner)
    return d


def _build(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return (type(e).__name__, str(e))


CONFIGS = [
    {},
    {"notification.webhook.enabled": True,
     "notification.webhook.url": "http://x/h",
     "notification.webhook.hmac_key": "k"},
    {"notification.webhook.enabled": "false",
     "notification.webhook.url": "http://x/h"},
    {"notification.aws.sqs.enabled": "true",
     "notification.aws.sqs.queue.url": "https://sqs.x/1/q",
     "notification.aws.sqs.region": "eu-west-1"},
    {"notification.memory.enabled": True, "notification.log.enabled": "1"},
    {"notification.gocdk_pub_sub.enabled": "yes",
     "notification.gocdk_pub_sub.topic_url": "mem://events"},
    {"notification.gocdk.pub.sub.enabled": "on",
     "notification.gocdk.pub.sub.topic.url":
         "awssqs://sqs.us-west-2.amazonaws.com/1/q",
     "notification.gocdk.pub.sub.access.key": "a"},
    {"notification.kafka.enabled": True},
    {"notification.webhook.enabled": True},
    {"notification.google_pub_sub.enabled": True},
]


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_publisher_from_config_matches_jax(i):
    got = [_describe(_build(lambda: q.publisher_from_config(CONFIGS[i])))
           for q in (ref_queues, port_queues)]
    assert got[0] == got[1]


GOCDK = [
    {"topic_url": "mem://events"},
    {"topic_url": "kafka://t"},
    {"topic_url": "awssqs://sqs.eu-west-1.amazonaws.com/123/q",
     "access_key": "k", "secret_key": "s"},
    {"topic_url": "awssqs://myhost/123/q"},
    {"topic_url": "awssqs://sqs.eu-west-1.amazonaws.com/1/q?region=eu-west-1",
     "region": "us-east-9"},
    {"topic_url": "gcppubsub://projects/p1/topics/t1"},
    {"topic_url": "gcppubsub://p1/t1"},
    {"topic_url": "gcppubsub://a/b/c"},
    {"topic_url": "http://127.0.0.1:1/hook", "retries": 2},
    {"topic_url": "rabbit://ex"},
    {},
]


@pytest.mark.parametrize("i", range(len(GOCDK)))
def test_gocdk_dispatch_matches_jax(i):
    got = [_describe(_build(lambda: q.make_publisher("gocdk_pub_sub",
                                                      **dict(GOCDK[i]))))
           for q in (ref_queues, port_queues)]
    assert got[0] == got[1]


def test_registry_memory_and_log_match_jax():
    assert sorted(port_queues.PUBLISHERS) == sorted(ref_queues.PUBLISHERS)
    outs = []
    for q in (ref_queues, port_queues):
        seen = []
        m = q.make_publisher("memory")
        m.subscribe(lambda k, e: seen.append((k, e)))
        m.send("/a", {"x": 1})
        stream = io.StringIO()
        log = q.make_publisher("log", stream=stream)
        log.send("/k", {"v": 2})
        outs.append((seen, m.events, stream.getvalue(),
                     _build(lambda: q.make_publisher("nope")),
                     _build(lambda: q.make_publisher("webhook")),
                     _build(lambda: q.make_publisher("aws_sqs")),
                     _build(lambda: q.make_publisher("kafka"))))
    assert outs[0] == outs[1]
