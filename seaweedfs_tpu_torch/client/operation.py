"""Client operations: assign, upload, lookup, read, delete. The JAX
package's ``client/operation.py``: ``assign`` asks the master for a file
id (``?count=`` grants that many keys, addressed ``fid``, ``fid_1``, ...:
``expand_batch_fids``); ``upload`` POSTs a multipart body to a volume
server, which fans it out to the volume's other replicas itself, with
the write token of the assign (``jwt=``, the answer's ``auth``) as
``Authorization: Bearer``, as ``delete_file`` does;
``VidCache`` keeps a volume's locations for ``ttl_seconds`` (or rides the
master's push channel with ``watch=True``); ``read_file_named`` tries
each location in turn and returns the body and its stored name."""

from __future__ import annotations

import email.message
import mimetypes
import time
from typing import Dict, List, Optional

from ..server.http_util import (HttpError, get_json, http_call,
                                http_get_with_headers, post_multipart)
from ..storage.types import parse_file_id


def assign(master_url: str, count: int = 1, collection: str = "",
           replication: str = "", ttl: str = "",
           data_center: str = "") -> dict:
    q = f"count={count}"
    if collection:
        q += f"&collection={collection}"
    if replication:
        q += f"&replication={replication}"
    if ttl:
        q += f"&ttl={ttl}"
    if data_center:
        q += f"&dataCenter={data_center}"
    return get_json(f"http://{master_url}/dir/assign?{q}")


def expand_batch_fids(fid: str, granted: int):
    """The fids of a ``count=`` assign's ``granted`` keys: fid, fid_1,
    fid_2, ... (one volume, one cookie)."""
    for i in range(granted):
        yield fid if i == 0 else f"{fid}_{i}"


def upload(url: str, fid: str, data: bytes, filename: str = "",
           content_type: str = "", ttl: str = "", jwt: str = "") -> dict:
    if not content_type:
        # from the name's extension; an explicit octet-stream is kept
        content_type = mimetypes.guess_type(filename or "")[0] \
            or "application/octet-stream"
    target = f"http://{url}/{fid}"
    if ttl:
        target += f"?ttl={ttl}"
    headers = {"Authorization": f"Bearer {jwt}"} if jwt else None
    return post_multipart(target, filename, data, content_type,
                          headers=headers)


def upload_data(master_url: str, data: bytes, filename: str = "",
                collection: str = "", replication: str = "",
                ttl: str = "", content_type: str = "") -> str:
    """Assign and upload; returns the fid."""
    a = assign(master_url, collection=collection, replication=replication,
               ttl=ttl)
    upload(a.get("fastUrl") or a["url"], a["fid"], data, filename,
           content_type, ttl, jwt=a.get("auth", ""))
    return a["fid"]


class VidCache:
    """Volume id -> locations, each kept ``ttl_seconds``. With
    ``watch=True`` the locations come from the master's push channel
    (``vid_map``), and the TTL'd ``/dir/lookup`` is only the fallback
    while the map warms up or the master is away."""

    def __init__(self, master_url: str, ttl_seconds: float = 10.0,
                 watch: bool = False):
        self.master_url = master_url
        self.ttl = ttl_seconds
        self._cache: Dict[int, tuple] = {}
        self._vid_map = None
        if watch:
            from .vid_map import shared_vid_map
            self._vid_map = shared_vid_map(master_url)

    def lookup(self, vid: int) -> List[str]:
        if self._vid_map is not None:
            urls = self._vid_map.lookup(vid)
            if urls is not None:
                return urls
        hit = self._cache.get(vid)
        if hit and time.time() - hit[0] < self.ttl:
            return [loc["url"] for loc in hit[1]]
        return [loc["url"] for loc in self._lookup_locations(vid)]

    def lookup_read(self, vid: int) -> List[str]:
        """Read routes: each holder's native read plane (where one is
        advertised) before its url."""
        from .vid_map import read_routes
        if self._vid_map is not None:
            urls = self._vid_map.lookup_read(vid)
            if urls is not None:
                return urls
        hit = self._cache.get(vid)
        if hit and time.time() - hit[0] < self.ttl:
            locs = hit[1]
        else:
            locs = self._lookup_locations(vid)
        return read_routes(locs)

    def _lookup_locations(self, vid: int) -> List[dict]:
        out = get_json(f"http://{self.master_url}/dir/lookup?volumeId={vid}")
        locs = out.get("locations", [])
        self._cache[vid] = (time.time(), locs)
        return locs

    def invalidate(self, vid: int, failed_urls=()):
        """Drop the cached routes; a pushed map also drops each of
        ``failed_urls`` until the master's next event."""
        self._cache.pop(vid, None)
        if self._vid_map is not None:
            for url in failed_urls:
                self._vid_map.discard_url(vid, url)


def lookup(master_url: str, vid: int) -> List[str]:
    out = get_json(f"http://{master_url}/dir/lookup?volumeId={vid}")
    return [loc["url"] for loc in out.get("locations", [])]


def lookup_read(master_url: str, vid: int) -> List[str]:
    from .vid_map import read_routes
    out = get_json(f"http://{master_url}/dir/lookup?volumeId={vid}")
    return read_routes(out.get("locations", []))


def read_file(master_url: str, fid: str,
              cache: Optional[VidCache] = None) -> bytes:
    return read_file_named(master_url, fid, cache)[0]


def read_file_named(master_url: str, fid: str,
                    cache: Optional[VidCache] = None):
    """(body, stored name or "") of a needle, from the first of the
    volume's locations that answers."""
    vid, _, _ = parse_file_id(fid)
    urls = cache.lookup_read(vid) if cache \
        else lookup_read(master_url, vid)
    last_err = None
    for u in urls:
        try:
            data, headers = http_get_with_headers(f"http://{u}/{fid}")
        except HttpError as e:
            last_err = e
            continue
        cd = {k.lower(): v for k, v in headers.items()}.get(
            "content-disposition", "")
        msg = email.message.Message()
        msg["content-disposition"] = cd
        name = msg.get_param("filename", header="content-disposition") or ""
        return data, (name if isinstance(name, str) else "")
    raise last_err or HttpError(404, f"no locations for {fid}")


def delete_file(master_url: str, fid: str,
                cache: Optional[VidCache] = None, jwt: str = "") -> bool:
    """DELETE at the first location that answers (the server fans the
    delete out to the other replicas), with ``jwt`` as its token."""
    vid, _, _ = parse_file_id(fid)
    urls = cache.lookup(vid) if cache else lookup(master_url, vid)
    headers = {"Authorization": f"Bearer {jwt}"} if jwt else None
    for u in urls:
        try:
            http_call("DELETE", f"http://{u}/{fid}", headers=headers)
            return True
        except HttpError:
            continue
    return False
