"""Message broker: the JAX package's ``server/msg_broker.py``
(reference weed/server/msg_broker_grpc_server.go): a log per topic with a
long-poll subscribe, on the filer's ``LogBuffer``; ``/queue/status``,
``/queue/topics``, ``/queue/publish``, ``/queue/subscribe`` and
``/queue/delete``, and ``QueueClient``."""

from __future__ import annotations

import base64
import time
from typing import Dict

from ..filer.log_buffer import LogBuffer
from ..util.locks import make_lock
from .http_util import HttpError, HttpServer, Request, Router


class MsgBrokerServer:
    def __init__(self, port: int = 17777, host: str = "127.0.0.1",
                 max_topics: int = 1024):
        router = Router()
        router.add("GET", "/queue/status", self.status_handler)
        router.add("GET", "/queue/topics", self.topics_handler)
        router.add("POST", "/queue/publish", self.publish_handler)
        router.add("GET", "/queue/subscribe", self.subscribe_handler)
        router.add("POST", "/queue/delete", self.delete_handler)
        self.server = HttpServer(port, router, host)
        self.port = self.server.port
        self.host = host
        self.max_topics = max_topics
        self.topics: Dict[str, LogBuffer] = {}
        self.lock = make_lock("torch.msg_broker.lock")

    def start(self):
        self.server.start()
        return self

    def stop(self):
        self.server.stop()
        with self.lock:
            for lb in self.topics.values():
                lb.close()
            self.topics.clear()

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    def _topic(self, name: str, create: bool = True) -> LogBuffer:
        if not name:
            raise HttpError(400, "missing topic")
        with self.lock:
            lb = self.topics.get(name)
            if lb is None:
                if not create:
                    raise HttpError(404, f"topic {name!r} not found")
                if len(self.topics) >= self.max_topics:
                    raise HttpError(429, "too many topics")
                lb = self.topics[name] = LogBuffer(flush_interval=3600)
            return lb

    # -- handlers ----------------------------------------------------------
    def status_handler(self, req: Request):
        with self.lock:
            return {"topics": len(self.topics)}

    def topics_handler(self, req: Request):
        with self.lock:
            return {"topics": sorted(self.topics)}

    def publish_handler(self, req: Request):
        lb = self._topic(req.query.get("topic", ""))
        ts = time.time()
        lb.append({
            "data": base64.b64encode(req.body or b"").decode(),
            "headers": {k[len("x-queue-"):].lower(): v
                        for k, v in req.headers.items()
                        if k.lower().startswith("x-queue-")},
        }, ts=ts)
        return {"position": repr(ts)}

    def subscribe_handler(self, req: Request):
        lb = self._topic(req.query.get("topic", ""), create=False)
        since = float(req.query.get("since", 0) or 0)
        timeout = min(float(req.query.get("timeout", 10) or 10), 55.0)
        events = lb.wait_since(since, timeout=timeout)
        return {"messages": [
            {"ts": t, "data": e["data"], "headers": e.get("headers", {})}
            for t, e in events]}

    def delete_handler(self, req: Request):
        name = req.query.get("topic", "")
        with self.lock:
            lb = self.topics.pop(name, None)
        if lb is None:
            raise HttpError(404, f"topic {name!r} not found")
        lb.close()
        return {"deleted": name}


class QueueClient:
    """Client helper (reference would be the SeaweedQueue stub's
    client side)."""

    def __init__(self, broker_url: str):
        self.url = f"http://{broker_url}"
        self.cursors: Dict[str, float] = {}

    def publish(self, topic: str, data: bytes, **headers):
        from .http_util import http_call
        import urllib.parse
        hdrs = {f"X-Queue-{k}": v for k, v in headers.items()}
        http_call("POST",
                  f"{self.url}/queue/publish?topic="
                  f"{urllib.parse.quote(topic)}", data, hdrs)

    def poll(self, topic: str, timeout: float = 1.0):
        from .http_util import get_json
        import urllib.parse
        since = self.cursors.get(topic, 0.0)
        out = get_json(
            f"{self.url}/queue/subscribe?topic="
            f"{urllib.parse.quote(topic)}&since={since!r}"
            f"&timeout={timeout}", timeout=timeout + 30)
        msgs = out.get("messages", [])
        if msgs:
            self.cursors[topic] = max(m["ts"] for m in msgs)
        return [(base64.b64decode(m["data"]), m.get("headers", {}))
                for m in msgs]
