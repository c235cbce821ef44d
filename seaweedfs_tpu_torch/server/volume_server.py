"""VolumeServer — the EC routes of a volume server.

The JAX package's ``server/volume_server.py`` in the part that
``ec.encode``, a rebuilder, a degraded read or a scrub on another server
calls: the server freezes and encodes its plain volumes, takes the
shards another server's encode pushes to it, and serves the shards of
the ``EcVolume``s in its directories.

    POST /admin/volume/readonly       freeze (or thaw) a volume
    POST /admin/ec/generate           encode a readonly volume: query only,
                                      every shard here; with an
                                      ``assignment`` body, each shard
                                      streamed to its holder
    POST /admin/ec/shard_write        a pushed shard's ranges: append at
                                      the staged offset (409 ``staged=``),
                                      ``action=finalize`` or ``abort``
    POST /admin/ec/copy               pull shard files and the .ecx (and
                                      the .vif/.ecj where present) from a
                                      source server
    POST /admin/ec/mount              mount shard files found here
    GET  /admin/ec/shard_read         ranged shard bytes: the query form
                                      (offset, size), or a Range header
                                      answered 206 with Content-Range
    POST /admin/ec/shard_repair_read  trace-repair symbol planes of a
                                      range (X-Repair-Planes/-Stride)
    POST /admin/ec/shard_plane_read   the piggyback repair half-plane of
                                      a window-aligned range
    GET  /admin/file                  a raw index or shard file
    *    /status                      the directories and EC shards held

Paths, query parameters, status codes, headers and JSON keys are the JAX
server's. The projections run on the host with numpy
(``ops/codec.project_slab``, ``pb_plane_slice``), as the JAX holder runs
them. Only ``/admin/ec/generate`` builds the store's codec (on
``device``, the card by default), so a server that only holds shards
never touches the card. Left out: the master heartbeat, needle reads and
writes, the rest of the admin plane, the whitelist and JWT guard, and
the ``trace_id`` and metrics exports of ``/admin/ec/generate`` (the port
has no ``util/tracing`` or ``stats/metrics``).

    python3 -m seaweedfs_tpu_torch.server.volume_server --dir D [--dir D2]
        [--host 127.0.0.1] [--port 0] [--device cuda]

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

from ..ec.constants import TOTAL_SHARDS, to_ext
from ..ops import codec as ops_codec
from ..storage.store import Store, volume_file_prefix
from .http_util import (HttpError, HttpServer, Request, Response, Router,
                        http_call, parse_range)


class VolumeServer:
    def __init__(self, port: int = 8080, host: str = "127.0.0.1",
                 directories=None, device: str = "cuda",
                 layout: str = "flat", codec=None):
        router = Router()
        router.add("*", "/status", self.status)
        router.add("POST", "/admin/volume/readonly", self.admin_readonly)
        router.add("POST", "/admin/ec/generate", self.admin_ec_generate)
        router.add("POST", "/admin/ec/mount", self.admin_ec_mount)
        router.add("POST", "/admin/ec/copy", self.admin_ec_copy)
        router.add("POST", "/admin/ec/shard_write",
                   self.admin_ec_shard_write)
        router.add("GET", "/admin/ec/shard_read", self.admin_ec_shard_read)
        router.add("POST", "/admin/ec/shard_repair_read",
                   self.admin_ec_shard_repair_read)
        router.add("POST", "/admin/ec/shard_plane_read",
                   self.admin_ec_shard_plane_read)
        router.add("GET", "/admin/file", self.admin_file)
        # without a ``codec``, the store builds RS(10,4) on ``device`` only
        # when an encode or a rebuild first needs it
        self.store = Store(directories or ["."], codec=codec, device=device,
                           layout=layout)
        self.server = HttpServer(port, router, host=host)
        self.host = host
        self.port = self.server.port
        self.url = f"{host}:{self.port}"
        self.store.public_url = self.url

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

    def admin_readonly(self, req: Request):
        vid = int(req.query["volume"])
        readonly = req.query.get("readonly", "true") == "true"
        was = self.store.mark_volume_readonly(vid, readonly)
        if was is None:
            raise HttpError(404, f"volume {vid} not found")
        # was_readonly lets an orchestrator restore exactly the prior state
        return {"volume": vid, "readonly": readonly, "was_readonly": was}

    def admin_ec_generate(self, req: Request):
        """Encode a readonly volume into shard files. Query only: every
        shard lands on this disk. When the POST body carries
        ``assignment`` ({shard: holder url}), the streaming encode+spread
        runs instead: each shard's slab ranges are pushed to its holder
        while later slabs encode, and shards bound for other holders
        never touch this disk."""
        vid = int(req.query["volume"])
        collection = req.query.get("collection", "")
        try:
            body = req.json()
        except ValueError:
            raise HttpError(400, "bad JSON body") from None
        if isinstance(body, dict) and body.get("assignment"):
            stats: dict = {}
            base, final = self.store.generate_ec_shards_streaming(
                vid, collection,
                assignment={int(s): u
                            for s, u in body["assignment"].items()},
                spares=body.get("spares") or [],
                window=int(body.get("window") or 0) or None,
                stats=stats,
                rate_mbps=float(body.get("rate_mbps") or 0.0))
            return {"volume": vid, "base": os.path.basename(base),
                    "assignment": {str(s): u for s, u in final.items()},
                    "stats": stats}
        base = self.store.generate_ec_shards(vid, collection)
        return {"volume": vid, "base": os.path.basename(base)}

    def _ec_stage_base(self, vid: int, collection: str) -> str:
        """Base path for incoming shard stages: the location already
        holding this volume's EC files if any (staged ranges, finalized
        shards and the later sidecar copy must all land at ONE base, or
        the mount will not see them), else a free location."""
        exts = [to_ext(s) for s in range(TOTAL_SHARDS)] + [".ecx"]
        for loc in self.store.locations:
            base = volume_file_prefix(loc.directory, collection, vid)
            if any(os.path.exists(base + e) or
                   os.path.exists(base + e + ".part") for e in exts):
                return base
        loc = self.store.find_free_location()
        if loc is None:
            raise HttpError(507, "no free disk location")
        return volume_file_prefix(loc.directory, collection, vid)

    def admin_ec_shard_write(self, req: Request):
        """Take one shard's ranges from a streaming encode+spread
        (ec/spread.py): chunked POSTs append at the expected offset into
        ``<shard>.part`` (a 409 carries the staged size on a mismatch, so
        a sender that lost an ack can tell delivered from diverged);
        ``action=finalize&size=`` checks the stage and renames it into
        place atomically; ``action=abort`` drops the stages. A failure
        never leaves a partial shard file."""
        vid = int(req.query["volume"])
        collection = req.query.get("collection", "")
        action = req.query.get("action", "append")
        if action == "abort":
            req.drain()
            removed = []
            for loc in self.store.locations:
                base = volume_file_prefix(loc.directory, collection, vid)
                for sid in range(TOTAL_SHARDS):
                    p = base + to_ext(sid) + ".part"
                    if os.path.exists(p):
                        os.remove(p)
                        removed.append(sid)
            return {"volume": vid, "aborted": removed}
        sid = int(req.query["shard"])
        base = self._ec_stage_base(vid, collection)
        part = base + to_ext(sid) + ".part"
        if action == "finalize":
            req.drain()
            size = int(req.query["size"])
            if not os.path.exists(part):
                raise HttpError(404, f"no staged shard {sid} for "
                                     f"volume {vid}")
            staged = os.path.getsize(part)
            if staged != size:
                raise HttpError(409, f"shard {sid} staged={staged} "
                                     f"expected={size}")
            os.replace(part, base + to_ext(sid))
            return {"volume": vid, "shard": sid, "size": size,
                    "finalized": True}
        off = int(req.query.get("offset", "0"))
        staged = os.path.getsize(part) if os.path.exists(part) else 0
        if off != staged and off != 0:
            # consume the (window-bounded) body, so the sender reads this
            # answer off a cleanly framed connection
            _ = req.body
            raise HttpError(409, f"shard {sid} offset mismatch: "
                                 f"staged={staged} offset={off}")
        data = req.body
        # offset 0 truncates: a replayed first range (failover to this
        # server, or a retry whose original died mid-body) starts clean
        with open(part, "wb" if off == 0 else "ab") as f:
            f.write(data)
            staged = f.tell()
        return {"volume": vid, "shard": sid, "staged": staged}

    def admin_ec_mount(self, req: Request):
        vid = int(req.query["volume"])
        collection = req.query.get("collection", "")
        shard_ids = [int(s) for s in req.query.get("shards", "").split(",")
                     if s != ""]
        mounted = self.store.mount_ec_shards(vid, collection, shard_ids)
        if not mounted and shard_ids:
            # tell "already mounted" from "files not found", so a wrong or
            # omitted collection fails loudly instead of doing nothing
            ev = self.store.find_ec_volume(vid)
            if ev is None or not set(shard_ids) & set(ev.shards):
                raise HttpError(
                    404, f"no shard files for volume {vid} "
                         f"collection={collection!r} here")
        return {"volume": vid, "mounted": mounted}

    def admin_ec_copy(self, req: Request):
        """Pull shard files, and with ``copy_ecx`` the .ecx, from a source
        server's ``/admin/file``. The .vif and .ecj are optional: a 404
        on either is skipped, any other status fails the copy (a skipped
        .vif would turn into a wrong offset-width guess on a parity-only
        holder)."""
        vid = int(req.query["volume"])
        collection = req.query.get("collection", "")
        source = req.query["source"]
        shard_ids = [int(s) for s in req.query.get("shards", "").split(",")
                     if s != ""]
        copy_ecx = req.query.get("copy_ecx", "true") == "true"
        # land next to any EC files this volume already has here: a
        # streamed spread may have staged shards on this server, and the
        # sidecars must join them at the same base for the mount
        base = self._ec_stage_base(vid, collection)
        name = os.path.basename(base)
        exts = [to_ext(s) for s in shard_ids]
        optional = []
        if copy_ecx:
            exts.append(".ecx")
            optional = [".vif", ".ecj"]
        copied = []
        for ext in exts + optional:
            try:
                data = http_call(
                    "GET", f"http://{source}/admin/file?name={name}{ext}",
                    timeout=300)
            except HttpError as e:
                if ext in optional and e.status == 404:
                    continue
                raise
            with open(base + ext, "wb") as f:
                f.write(data)
            copied.append(ext)
        return {"volume": vid, "copied": copied}

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
        description="Serve the volumes and EC shards of the given "
                    "directories over the EC routes.")
    ap.add_argument("--dir", action="append", required=True,
                    help="a directory of EC volumes (repeatable)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks a free port")
    ap.add_argument("--device", default="cuda",
                    help="where /admin/ec/generate encodes (cuda or cpu)")
    args = ap.parse_args(argv)
    vs = VolumeServer(port=args.port, host=args.host,
                      directories=args.dir, device=args.device).start()
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
