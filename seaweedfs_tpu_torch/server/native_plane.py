"""The native data plane of a volume server: ctypes over csrc/http_plane.cc.

The JAX package's ``server/native_plane.py``. The C++ library is a
thread-per-connection HTTP/1.1 server on a second advertised port
(``fastUrl``) that serves plain needle GETs, HEADs and Range reads, and
plain multipart POSTs and DELETEs of volumes whose write lease it holds,
without the GIL (reference weed/server/volume_server_handlers_read.go,
_write.go). Everything else (EC reads it cannot fill, gzip payloads,
chunk manifests, Seaweed-* pairs, resize queries, query parameters,
leaseless writes) it answers with a 307 to the Python server, which
stays the source of truth.

* The index it serves from is a mirror pushed from Python:
  ``register_volume`` bulk-loads a volume's needle map, ``put`` and
  ``delete`` follow each Python write of a leaseless volume.
* The write lease (``enable_writer`` -> ``NativeWriter``, the volume's
  ``fast_writer``): the plane becomes the one writer of the .dat and .idx
  tails, Python's own appends go through ``NativeWriter.append`` under
  the same mutex, and ``disable_writer`` (a mutex barrier) hands the
  tails back.
* Group commit (``set_sync_mode``): ``off`` acks from the page cache,
  ``group`` acks each batch of appends after one covering fdatasync of
  the .dat and .idx, ``always`` fdatasyncs each append. The mode is
  taken when a lease is enabled, so a change takes effect on the next
  lease.
* EC volumes and the slab cache: ``register_ec_volume`` pushes the
  geometry, the local shard files and the .ecx; a read through a lost
  shard is served from slabs ``cache_put`` published (the degraded
  engine's reconstructions on K1) and redirected to Python on a miss.

The library is built from csrc/http_plane.cc with the host C++
compiler into ``seaweedfs_tpu_torch/build/`` at first use (and again
when the source is newer), under a temporary name renamed into place so
processes building at once never load half a file; ``SW_HTTP_PLANE_LIB``
names a library to load in its place, which must exist. A build or load
that fails sets ``BUILD_FAILED`` (the ``plane_build_failed`` gauge), and
the server runs without the plane. ``build_loadgen`` builds
csrc/loadgen.cc, the keep-alive load generator that measures the plane.
"""

from __future__ import annotations

import ctypes
import json
from pathlib import Path
from typing import Optional

import numpy as np

from ..ec.constants import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, TOTAL_SHARDS
from ..ec.ec_volume import EcShardNotFound
from ..storage.compact_map import snapshot_live_items
from ..storage.types import bytes_to_entry, entry_size, max_volume_size
from ..storage.volume import VolumeError
from ..util import config
from ..util.host_build import compile_host, stale
from ..util.locks import make_lock

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "http_plane.cc"
LOADGEN_SOURCE = _PKG / "csrc" / "loadgen.cc"
BUILD_DIR = _PKG / "build"
LIBRARY = BUILD_DIR / "libseaweed_http.so"
LOADGEN = BUILD_DIR / "loadgen"
CXX_FLAGS = ("-O2", "-std=c++17", "-pthread")

_lib = None
_lib_lock = make_lock("torch.native_plane._lib_lock")
BUILD_FAILED = False    # the one-time build or load failed


def build_failed() -> bool:
    return BUILD_FAILED


def _library_path() -> Path:
    return Path(config.env_str("SW_HTTP_PLANE_LIB") or LIBRARY)


def build_library() -> str:
    """Build csrc/http_plane.cc into build/libseaweed_http.so."""
    return compile_host(SOURCE, LIBRARY, (*CXX_FLAGS, "-fPIC", "-shared"))


def compile_loadgen() -> str:
    """Build csrc/loadgen.cc into build/loadgen."""
    return compile_host(LOADGEN_SOURCE, LOADGEN, CXX_FLAGS)


def build_loadgen() -> Path:
    """The load generator, built when missing or older than its
    source."""
    if stale(LOADGEN, LOADGEN_SOURCE):
        compile_loadgen()
    return LOADGEN


# (name, argtypes, restype) of every function the library exports
_C = ctypes
_P = _C.c_void_p
_U64P = _C.POINTER(_C.c_uint64)
ABI = (
    ("swhp_start", [_C.c_char_p, _C.c_uint16, _C.c_char_p, _C.c_int], _P),
    ("swhp_port", [_P], _C.c_uint16),
    ("swhp_add_volume", [_P, _C.c_uint32, _C.c_char_p, _C.c_int], _C.c_int),
    ("swhp_remove_volume", [_P, _C.c_uint32], _C.c_int),
    ("swhp_put", [_P, _C.c_uint32, _C.c_uint64, _C.c_uint64, _C.c_uint32],
     _C.c_int),
    ("swhp_put_bulk", [_P, _C.c_uint32, _P, _P, _P, _C.c_int64], _C.c_int),
    ("swhp_delete", [_P, _C.c_uint32, _C.c_uint64], _C.c_int),
    ("swhp_served", [_P], _C.c_uint64),
    ("swhp_redirected", [_P], _C.c_uint64),
    ("swhp_written", [_P], _C.c_uint64),
    ("swhp_enable_writer", [_P, _C.c_uint32, _C.c_char_p, _C.c_int,
                            _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int],
     _C.c_int),
    ("swhp_disable_writer", [_P, _C.c_uint32], _C.c_int64),
    ("swhp_set_accept_posts", [_P, _C.c_uint32, _C.c_int], _C.c_int),
    ("swhp_append", [_P, _C.c_uint32, _C.c_char_p, _C.c_int64, _C.c_uint64,
                     _C.c_uint32, _C.c_int, _C.c_uint32], _C.c_int64),
    ("swhp_lookup", [_P, _C.c_uint32, _C.c_uint64, _U64P,
                     _C.POINTER(_C.c_uint32)], _C.c_int),
    ("swhp_writer_counters", [_P, _C.c_uint32, _U64P], _C.c_int),
    ("swhp_stop", [_P], None),
    ("swhp_stats_len", [], _C.c_int),
    ("swhp_stats", [_P, _U64P, _C.c_int], _C.c_int),
    ("swhp_lat_bounds", [_U64P, _C.c_int], _C.c_int),
    ("swhp_slow_ring", [_P, _C.c_char_p, _C.c_int], _C.c_int),
    ("swhp_set_stats_enabled", [_P, _C.c_int], None),
    ("swhp_set_slow_us", [_P, _C.c_uint64], None),
    ("swhp_set_sync_mode", [_P, _C.c_int, _C.c_uint64, _C.c_uint64],
     _C.c_int),
    ("swhp_sync_stats_len", [], _C.c_int),
    ("swhp_sync_stats", [_P, _U64P, _C.c_int], _C.c_int),
    ("swhp_ec_register", [_P, _C.c_uint32, _C.c_int, _C.c_int64, _C.c_int64,
                          _C.c_int64, _C.c_int64], _C.c_int),
    ("swhp_ec_set_shard", [_P, _C.c_uint32, _C.c_int, _C.c_char_p],
     _C.c_int),
    ("swhp_ec_put_bulk", [_P, _C.c_uint32, _P, _P, _P, _C.c_int64],
     _C.c_int),
    ("swhp_ec_delete", [_P, _C.c_uint32, _C.c_uint64], _C.c_int),
    ("swhp_ec_unregister", [_P, _C.c_uint32], _C.c_int),
    ("swhp_cache_configure", [_P, _C.c_uint64], None),
    ("swhp_cache_put", [_P, _C.c_uint32, _C.c_int, _C.c_uint64, _C.c_char_p,
                        _C.c_uint64], _C.c_int),
    ("swhp_cache_invalidate", [_P, _C.c_uint32, _C.c_int], _C.c_uint64),
    ("swhp_cache_stats_len", [], _C.c_int),
    ("swhp_cache_stats", [_P, _U64P, _C.c_int], _C.c_int),
)


def _load() -> Optional[ctypes.CDLL]:
    """The library, built first when it is missing or older than its
    source; None once a build or load has failed. An explicit
    SW_HTTP_PLANE_LIB that does not exist raises."""
    global _lib, BUILD_FAILED
    with _lib_lock:
        if _lib is not None:
            return _lib or None
        path = _library_path()
        if config.env_is_set("SW_HTTP_PLANE_LIB"):
            if not path.exists():
                raise FileNotFoundError(
                    f"SW_HTTP_PLANE_LIB={path} does not exist")
        try:
            if not config.env_is_set("SW_HTTP_PLANE_LIB") and \
                    stale(path, SOURCE):
                build_library()
            lib = ctypes.CDLL(str(path))
            for name, argtypes, restype in ABI:
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
        except (OSError, RuntimeError, AttributeError):
            BUILD_FAILED = True
            _lib = False
            return None
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def lat_bounds_us() -> tuple:
    """The upper bounds (us) of the plane's latency buckets; the +Inf
    bucket is implicit. Empty without the library."""
    lib = _load()
    if lib is None:
        return ()
    buf = (ctypes.c_uint64 * 32)()
    n = lib.swhp_lat_bounds(buf, 32)
    return tuple(int(buf[i]) for i in range(max(0, n)))


def _bulk(fn, h, vid, keys, offsets, sizes):
    ka = np.asarray(keys, dtype=np.uint64)
    oa = np.asarray(offsets, dtype=np.uint64)
    sa = np.asarray(sizes, dtype=np.uint32)
    fn(h, vid, ka.ctypes.data_as(ctypes.c_void_p),
       oa.ctypes.data_as(ctypes.c_void_p),
       sa.ctypes.data_as(ctypes.c_void_p), len(keys))


_BULK = 1 << 20     # entries per bulk push (bounds the staging lists)


class NativeReadPlane:
    """One native plane owned by a volume server: listening on
    ``host:port`` (0 picks a port), redirecting what it does not serve
    to ``fallback_hostport``. The knobs of ``util/config`` set its stats,
    slow-ring threshold, slab-cache budget and sync mode."""

    def __init__(self, host: str, port: int, fallback_hostport: str,
                 max_conns: int = 1024):
        lib = _load()
        if lib is None:
            raise RuntimeError("the native plane library is unavailable")
        self._lib = lib
        self._h = lib.swhp_start(host.encode(), port,
                                 fallback_hostport.encode(), max_conns)
        if not self._h:
            raise RuntimeError(
                f"native plane failed to listen on {host}:{port}")
        self.host = host
        self.port = lib.swhp_port(self._h)
        lib.swhp_set_stats_enabled(
            self._h, 1 if config.env_bool("SW_PLANE_STATS") else 0)
        lib.swhp_set_slow_us(self._h,
                             max(0, config.env_int("SW_PLANE_SLOW_US")))
        lib.swhp_cache_configure(
            self._h, max(0, config.env_int("SW_PLANE_CACHE_BYTES")))
        self.set_sync_mode(config.env_str("SW_PLANE_FSYNC_MODE"),
                           config.env_int("SW_PLANE_FSYNC_BATCH_US"),
                           config.env_int("SW_PLANE_FSYNC_MAX_PENDING"))

    # -- volumes -----------------------------------------------------------
    def register_volume(self, volume) -> bool:
        """Open the volume's .dat and load its live needle map (taken
        under the volume lock: the map changes under writes). Reads that
        miss in the window are redirected, never answered 404."""
        h = self._h
        if not h:
            return False
        if self._lib.swhp_add_volume(h, volume.id, volume.dat_path.encode(),
                                     volume.version) != 0:
            return False
        with volume.lock:
            entries = snapshot_live_items(volume.nm)
        keys, offsets, sizes = [], [], []
        with entries:
            for key, nv in entries:
                keys.append(key)
                offsets.append(nv.offset)
                sizes.append(nv.size)
                if len(keys) >= _BULK:
                    _bulk(self._lib.swhp_put_bulk, h, volume.id, keys,
                          offsets, sizes)
                    keys, offsets, sizes = [], [], []
        if keys:
            _bulk(self._lib.swhp_put_bulk, h, volume.id, keys, offsets,
                  sizes)
        return True

    def unregister_volume(self, vid: int):
        h = self._h
        if h:
            self._lib.swhp_remove_volume(h, vid)

    def put(self, vid: int, key: int, offset: int, size: int):
        h = self._h
        if h:
            self._lib.swhp_put(h, vid, key, offset, size)

    def delete(self, vid: int, key: int):
        h = self._h
        if h:
            self._lib.swhp_delete(h, vid, key)

    # -- the write lease ---------------------------------------------------
    def enable_writer(self, volume, file_size_limit: int = 0,
                      accept_posts: bool = False):
        """Hand the volume's tails to the plane (caller holds the volume
        lock, and registered the volume under the same hold). Returns
        the ``NativeWriter``, or None."""
        h = self._h
        if not h:
            return None
        rc = self._lib.swhp_enable_writer(
            h, volume.id, volume.idx_path.encode(), volume.offset_width,
            volume.size(), max_volume_size(volume.offset_width),
            int(file_size_limit), 1 if accept_posts else 0)
        return NativeWriter(self, volume.id) if rc == 0 else None

    def disable_writer(self, vid: int) -> int:
        """Take the lease back (after this returns no plane append is in
        flight); the tail offset, or -1 without a writer."""
        h = self._h
        return int(self._lib.swhp_disable_writer(h, vid)) if h else -1

    # -- EC volumes and the slab cache -------------------------------------
    def register_ec_volume(self, ev, slab_bytes: int) -> bool:
        """Push an EC volume's geometry, its local shard files and its
        .ecx (tombstones too, so a deleted needle is redirected, not
        served) into the plane. ``slab_bytes`` is the degraded engine's
        slab: cached slabs are addressed by index. A fresh record
        replaces the old one, so calling it after every mount and
        unmount keeps the shard set exact."""
        h = self._h
        if not h:
            return False
        try:
            dat_size = ev._dat_size_hint()
        except EcShardNotFound:
            return False
        if self._lib.swhp_ec_register(
                h, ev.vid, ev.version, dat_size, LARGE_BLOCK_SIZE,
                SMALL_BLOCK_SIZE, int(slab_bytes)) != 0:
            return False
        for sid in range(TOTAL_SHARDS):
            shard = ev.shards.get(sid)
            self._lib.swhp_ec_set_shard(
                h, ev.vid, sid,
                shard.path.encode() if shard is not None else None)
        rec = entry_size(ev.offset_width)
        with ev.ecx_lock:
            ev.ecx_file.seek(0)
            raw = ev.ecx_file.read(ev.ecx_size)
        keys, offsets, sizes = [], [], []
        for pos in range(0, len(raw) - rec + 1, rec):
            key, offset, size = bytes_to_entry(raw[pos:pos + rec])
            keys.append(key)
            offsets.append(offset)
            sizes.append(size)
            if len(keys) >= _BULK:
                _bulk(self._lib.swhp_ec_put_bulk, h, ev.vid, keys, offsets,
                      sizes)
                keys, offsets, sizes = [], [], []
        if keys:
            _bulk(self._lib.swhp_ec_put_bulk, h, ev.vid, keys, offsets,
                  sizes)
        return True

    def unregister_ec_volume(self, vid: int):
        h = self._h
        if h:
            self._lib.swhp_ec_unregister(h, vid)

    def ec_delete(self, vid: int, key: int):
        """Mirror an EC needle's tombstone."""
        h = self._h
        if h:
            self._lib.swhp_ec_delete(h, vid, key)

    def cache_put(self, vid: int, sid: int, idx: int, data: bytes) -> bool:
        """Publish one reconstructed slab."""
        h = self._h
        return bool(h) and self._lib.swhp_cache_put(
            h, vid, sid, idx, data, len(data)) == 0

    def cache_invalidate(self, vid: int, sid: int = -1) -> int:
        """Drop the cached slabs of (vid, sid), or of every shard of
        ``vid`` when ``sid`` < 0; the entries removed."""
        h = self._h
        return int(self._lib.swhp_cache_invalidate(h, vid, sid)) if h else 0

    _CACHE_STATS_FIELDS = (
        "puts", "put_bytes", "hits", "misses", "evictions", "invalidated",
        "entries", "bytes", "max_bytes", "degraded_served",
        "degraded_redirected", "ec_local_served")

    def _flat(self, len_fn, stats_fn) -> Optional[list]:
        h = self._h
        if not h:
            return None
        n = int(len_fn())
        buf = (ctypes.c_uint64 * n)()
        if stats_fn(h, buf, n) != n:
            return None
        return [int(x) for x in buf]

    def cache_stats(self) -> Optional[dict]:
        """The slab cache's counters and the EC reads' outcomes; None
        once stopped."""
        vals = self._flat(self._lib.swhp_cache_stats_len,
                          self._lib.swhp_cache_stats)
        return None if vals is None else \
            dict(zip(self._CACHE_STATS_FIELDS, vals))

    # -- counters ----------------------------------------------------------
    @property
    def served(self) -> int:
        h = self._h
        return int(self._lib.swhp_served(h)) if h else 0

    @property
    def redirected(self) -> int:
        h = self._h
        return int(self._lib.swhp_redirected(h)) if h else 0

    @property
    def written(self) -> int:
        h = self._h
        return int(self._lib.swhp_written(h)) if h else 0

    _STATS_HEAD = ("requests", "status_1xx", "status_2xx", "status_3xx",
                   "status_4xx", "status_5xx", "bytes_sent", "redirects",
                   "index_misses", "lat_count", "lat_sum_us")

    def _with_buckets(self, head, vals) -> dict:
        out = dict(zip(head, vals))
        counts = vals[len(head):]
        bounds = list(lat_bounds_us())[:len(counts) - 1]
        out["buckets"] = list(zip(bounds + [None], counts))
        return out

    def stats(self) -> Optional[dict]:
        """The flat counters and the us latency histogram as
        non-cumulative (bound_us, count) pairs, the last for +Inf with
        bound None; None once stopped."""
        vals = self._flat(self._lib.swhp_stats_len, self._lib.swhp_stats)
        return None if vals is None else \
            self._with_buckets(self._STATS_HEAD, vals)

    def slow_requests(self) -> list:
        """The slow-request ring, newest first (method, target, status,
        bytes, micros, unix_ms)."""
        h = self._h
        if not h:
            return []
        buf = ctypes.create_string_buffer(1 << 16)
        n = self._lib.swhp_slow_ring(h, buf, len(buf))
        if n <= 0:
            return []
        try:
            return json.loads(buf.raw[:n].decode("utf-8", "replace"))
        except ValueError:
            return []

    _SYNC_MODES = {"off": 0, "group": 1, "always": 2}
    _SYNC_MODE_NAMES = {v: k for k, v in _SYNC_MODES.items()}

    def set_sync_mode(self, mode, batch_us: int, max_pending: int) -> bool:
        """The durability of leases enabled from now on: ``off``,
        ``group`` or ``always`` (any other string is ``off``)."""
        h = self._h
        if not h:
            return False
        code = self._SYNC_MODES.get(str(mode).strip().lower(), 0)
        return self._lib.swhp_set_sync_mode(
            h, code, max(0, int(batch_us)), max(1, int(max_pending))) == 0

    _SYNC_STATS_HEAD = ("mode", "batch_us", "max_pending", "batches",
                        "riders", "failures", "pending", "fsync_us_sum")

    def sync_stats(self) -> Optional[dict]:
        """The durability config, the batches (fdatasync pairs), riders,
        failures and pending appends, and the fsync us histogram as
        (bound_us, count) pairs; the mode as its name. None once
        stopped."""
        vals = self._flat(self._lib.swhp_sync_stats_len,
                          self._lib.swhp_sync_stats)
        if vals is None:
            return None
        out = self._with_buckets(self._SYNC_STATS_HEAD, vals)
        out["mode"] = self._SYNC_MODE_NAMES.get(out["mode"], "off")
        return out

    def stop(self):
        if self._h:
            self._lib.swhp_stop(self._h)
            self._h = None


class NativeWriter:
    """The write lease a volume holds while the plane owns its tails
    (``Volume.fast_writer``): the one append path, the exact index, and
    the counters the volume adds to its frozen needle map's."""

    __slots__ = ("_plane", "vid")

    def __init__(self, plane: NativeReadPlane, vid: int):
        self._plane = plane
        self.vid = vid

    def append(self, blob: bytes, key: int, size_field: int,
               cookie: int = 0, check_cookie: bool = True) -> int:
        """Append one record (``size_field`` 0xFFFFFFFF for a tombstone);
        its .dat offset. The cookie of an overwrite or a delete is
        checked again under the append mutex. VolumeError: past the
        offset width's ceiling, or a cookie mismatch; OSError: the
        append's durability is unknown (an I/O error, a poisoned group
        commit), never acknowledged, so a retry is a harmless
        duplicate."""
        h = self._plane._h
        if not h:
            raise OSError("native plane stopped")
        off = self._plane._lib.swhp_append(
            h, self.vid, blob, len(blob), key, size_field,
            1 if check_cookie else 0, cookie)
        if off == -2:
            raise VolumeError(f"volume {self.vid}: write exceeds the "
                              f"offset-width addressing ceiling")
        if off == -4:
            raise VolumeError(f"needle {key}: mismatching cookie on "
                              f"overwrite")
        if off == -5:
            raise OSError(f"volume {self.vid}: group-commit batch poisoned"
                          f" — durability of the append is unknown")
        if off < 0:
            raise OSError(f"native append failed on volume {self.vid} "
                          f"({off})")
        return off

    def lookup(self, key: int):
        """(offset, size) from the plane's exact mirror, or None."""
        h = self._plane._h
        if not h:
            return None
        off, size = ctypes.c_uint64(), ctypes.c_uint32()
        if self._plane._lib.swhp_lookup(h, self.vid, key, ctypes.byref(off),
                                        ctypes.byref(size)):
            return off.value, size.value
        return None

    def counters(self):
        """(puts, put_bytes, deletes, deleted_bytes, max_key, tail)."""
        h = self._plane._h
        buf = (ctypes.c_uint64 * 6)()
        if not h or self._plane._lib.swhp_writer_counters(
                h, self.vid, buf) != 0:
            return (0, 0, 0, 0, 0, 0)
        return tuple(int(x) for x in buf)

    def set_accept_posts(self, on: bool):
        h = self._plane._h
        if h:
            self._plane._lib.swhp_set_accept_posts(h, self.vid,
                                                   1 if on else 0)

    def release(self) -> int:
        """Hand the lease back (the committer drains its last batch
        first)."""
        return self._plane.disable_writer(self.vid)
