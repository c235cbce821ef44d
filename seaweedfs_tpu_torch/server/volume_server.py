"""VolumeServer — the EC holder routes of a volume server.

The JAX package's ``server/volume_server.py`` in the part a rebuilder,
a degraded read or a scrub on another server calls: the holder serves
the shards of the ``EcVolume``s found in its directories.

    GET  /admin/ec/shard_read         ranged shard bytes: the query form
                                      (offset, size), or a Range header
                                      answered 206 with Content-Range
    POST /admin/ec/shard_repair_read  trace-repair symbol planes of a
                                      range (X-Repair-Planes/-Stride)
    POST /admin/ec/shard_plane_read   the piggyback repair half-plane of
                                      a window-aligned range
    GET  /admin/file                  a raw index or shard file
    *    /status                      the directories and EC shards held

Paths, query parameters, status codes and headers are the JAX server's.
The projections run on the host with numpy (``ops/codec.project_slab``,
``pb_plane_slice``), as the JAX holder runs them; the holder never
touches the card. Left out: the master heartbeat, needle reads and
writes, the rest of the admin plane, and the whitelist and JWT guard.

    python3 -m seaweedfs_tpu_torch.server.volume_server --dir D [--dir D2]
        [--host 127.0.0.1] [--port 0]

serves until killed and prints ``listening <host>:<port>`` once bound,
so a parent process that passed ``--port 0`` can read the port.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

import numpy as np

from ..ops import codec as ops_codec
from ..storage.store import Store
from .http_util import (HttpError, HttpServer, Request, Response, Router,
                        parse_range)


class VolumeServer:
    def __init__(self, port: int = 8080, host: str = "127.0.0.1",
                 directories=None):
        router = Router()
        router.add("*", "/status", self.status)
        router.add("GET", "/admin/ec/shard_read", self.admin_ec_shard_read)
        router.add("POST", "/admin/ec/shard_repair_read",
                   self.admin_ec_shard_repair_read)
        router.add("POST", "/admin/ec/shard_plane_read",
                   self.admin_ec_shard_plane_read)
        router.add("GET", "/admin/file", self.admin_file)
        # shards are only served here, so the store never builds a codec
        self.store = Store(directories or ["."])
        self.server = HttpServer(port, router, host=host)
        self.host = host
        self.port = self.server.port
        self.url = f"{host}:{self.port}"

    def start(self) -> "VolumeServer":
        self.server.start()
        return self

    def stop(self):
        self.server.stop()
        self.store.close()

    def status(self, req: Request):
        return {"url": self.url,
                "directories": [loc.directory
                                for loc in self.store.locations],
                "ec_volumes": [
                    {"id": vid, "collection": ev.collection,
                     "shards": ev.shard_ids()}
                    for loc in self.store.locations
                    for vid, ev in sorted(loc.ec_volumes.items())]}

    def _shard(self, req: Request):
        vid = int(req.query["volume"])
        sid = int(req.query["shard"])
        ev = self.store.find_ec_volume(vid)
        if ev is None or sid not in ev.shards:
            raise HttpError(404, f"shard {vid}.{sid} not here")
        return ev.shards[sid]

    def admin_ec_shard_read(self, req: Request):
        """Ranged shard reads for the streaming gather. Two forms:
        ``offset``/``size`` query parameters, or a ``Range: bytes=a-b``
        / ``bytes=-N`` header answered 206 with ``Content-Range`` (whose
        ``/total`` lets a rebuilder size a shard with a 1-byte probe)."""
        shard = self._shard(req)
        total = shard.size
        rng = parse_range(req.headers.get("Range", ""), total)
        if rng is None:
            offset = int(req.query.get("offset", 0))
            size = int(req.query.get("size", 0))
            return Response(shard.read_at(offset, size),
                            headers={"Accept-Ranges": "bytes"})
        offset, length = rng
        if length == 0:
            return Response(b"", headers={"Accept-Ranges": "bytes"})
        return Response(
            shard.read_at(offset, length), status=206,
            headers={
                "Accept-Ranges": "bytes",
                "Content-Range":
                    f"bytes {offset}-{offset + length - 1}/{total}",
            })

    def admin_ec_shard_repair_read(self, req: Request):
        """Projected shard read for trace repair: read the range of a
        local shard, apply the caller's GF(2^8) trace masks, and return
        only the packed symbol planes, ``len(masks)`` planes of
        ``ceil(size/8)`` bytes. The full range never leaves the
        holder."""
        shard = self._shard(req)
        try:
            offset = int(req.query.get("offset", 0))
            size = int(req.query["size"])
            masks = [int(x) for x in req.query["masks"].split(",")]
        except (KeyError, ValueError):
            raise HttpError(400, "need offset/size/masks query params")
        if offset < 0 or size <= 0:
            raise HttpError(400, f"bad range {offset}+{size}")
        if not masks or any(not (0 < x < 256) for x in masks):
            raise HttpError(400, f"masks must be 1..255, got {masks}")
        if offset + size > shard.size:
            raise HttpError(
                416, f"range {offset}+{size} beyond shard size {shard.size}")
        data = np.frombuffer(shard.read_at(offset, size), dtype=np.uint8)
        planes = ops_codec.project_slab(data, masks)
        return Response(
            planes.tobytes(),
            headers={
                "X-Repair-Planes": str(planes.shape[0]),
                "X-Repair-Stride": str(planes.shape[1]),
            })

    def admin_ec_shard_plane_read(self, req: Request):
        """Half-plane shard read for piggyback repair: read the
        window-aligned range of a local shard and return only the
        sub-chunks of the caller's repair plane, ``size/2`` bytes."""
        shard = self._shard(req)
        try:
            offset = int(req.query.get("offset", 0))
            size = int(req.query["size"])
            alpha = int(req.query["alpha"])
            window = int(req.query["window"])
            bit = int(req.query["bit"])
            side = int(req.query["side"])
        except (KeyError, ValueError):
            raise HttpError(
                400, "need offset/size/alpha/window/bit/side query params")
        if offset < 0 or size <= 0:
            raise HttpError(400, f"bad range {offset}+{size}")
        if alpha < 2 or alpha & (alpha - 1) or window % alpha:
            raise HttpError(
                400, f"bad sub-chunk geometry alpha={alpha} "
                     f"window={window}")
        if not (0 <= bit < alpha.bit_length() - 1) or side not in (0, 1):
            raise HttpError(400, f"bad plane bit={bit} side={side}")
        if offset % window or size % window:
            raise HttpError(
                400, f"range {offset}+{size} not aligned to "
                     f"window {window}")
        if offset + size > shard.size:
            raise HttpError(
                416, f"range {offset}+{size} beyond shard size {shard.size}")
        data = np.frombuffer(shard.read_at(offset, size), dtype=np.uint8)
        plane = ops_codec.pb_plane_slice(data, alpha, window, bit, side)
        return Response(
            plane.tobytes(),
            headers={
                "X-Plane-Alpha": str(alpha),
                "X-Plane-Window": str(window),
            })

    def admin_file(self, req: Request):
        """Serve a raw storage file (the index sidecars a rebuilder
        fetches). Restricted to the store's own directories and known
        extensions."""
        name = os.path.basename(req.query.get("name", ""))
        ok_ext = name.endswith((".ecx", ".ecj", ".vif", ".dat", ".idx")) \
            or ".ec" in name
        if not name or not ok_ext:
            raise HttpError(400, "bad file name")
        for loc in self.store.locations:
            path = os.path.join(loc.directory, name)
            if os.path.exists(path):
                if req.query.get("stat"):
                    return {"size": os.path.getsize(path)}
                offset = int(req.query.get("offset", 0))
                size = int(req.query.get("size", 0)) \
                    or os.path.getsize(path) - offset
                return Response(body_path=path, body_range=(offset, size))
        raise HttpError(404, f"{name} not found")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve the EC shards of the given directories over "
                    "the holder routes.")
    ap.add_argument("--dir", action="append", required=True,
                    help="a directory of EC volumes (repeatable)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks a free port")
    args = ap.parse_args(argv)
    vs = VolumeServer(port=args.port, host=args.host,
                      directories=args.dir).start()
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    print(f"listening {vs.url}", flush=True)
    while not done.wait(1.0):
        pass
    vs.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
