"""Tier moves: ship a readonly volume's .dat to a remote backend, and
bring it back.

The JAX package's ``storage/volume_tier.py`` (reference
weed/storage/volume_tier.go, server/volume_grpc_tier_upload.go and
_download.go). The .vif sidecar (the reference's protobuf VolumeInfo,
JSON here, with the JAX keys ``version`` and
``remote.{backend,key,file_size,modified_at}``) records where the .dat
lives; reads become range requests through ``backend.RemoteFile`` while
the .idx and the needle map stay local.
"""

from __future__ import annotations

import json
import os
import time

from .backend import RemoteFile, get_backend
from .volume import Volume, VolumeError


def vif_path(volume: Volume) -> str:
    return volume.file_name() + ".vif"


def save_volume_info(path: str, info: dict):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(info, f, indent=1)
    os.replace(tmp, path)


def load_volume_info(path: str):
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (ValueError, OSError):
        return None


def upload_dat(volume: Volume, spec: str, keep_local: bool = False) -> dict:
    """Copy the .dat to backend ``spec``. The volume must be readonly
    already (the shell's ``volume.tier.upload`` freezes every replica
    first). With ``keep_local`` the volume keeps serving from its local
    .dat and the remote copy is a parked duplicate; without, the local
    .dat goes and reads become range requests. The transfer runs outside
    ``volume.lock``: the .dat cannot change while readonly, and holding
    the lock across a long upload would stall every read and the
    heartbeat (which takes it in ``size()``). A volume made writable
    again during the transfer abandons the upload."""
    with volume.lock:
        if not volume.readonly:
            raise VolumeError(
                f"volume {volume.id} must be readonly before tier upload")
        if isinstance(volume.dat, RemoteFile):
            raise VolumeError(f"volume {volume.id} is already remote")
        backend = get_backend(spec)
        volume.dat.flush()
        size = volume.size()
        key = os.path.basename(volume.dat_path)

    backend.upload_file(volume.dat_path, key)

    with volume.lock:
        if not volume.readonly:
            backend.delete(key)
            raise VolumeError(
                f"volume {volume.id} became writable during tier upload")
        info = {
            "version": volume.version,
            "remote": {
                "backend": spec,
                "key": key,
                "file_size": size,
                "modified_at": int(time.time()),
            },
        }
        save_volume_info(vif_path(volume), info)
        if not keep_local:
            volume.dat.close()
            volume.dat = RemoteFile(backend, key, size)
            os.remove(volume.dat_path)
        return info


def download_dat(volume: Volume, delete_remote: bool = False) -> dict:
    """Bring a remote .dat back to local disk and drop the .vif. The pull
    lands in ``.tierdl`` outside ``volume.lock``, its size checked
    against the .vif; only the swap is locked, and a failed pull leaves
    no file behind.

    A keep-local upload left the live .dat beside the .vif: the volume
    never stopped serving from disk, so only the .vif goes (and, with
    ``delete_remote``, the remote object); the parked copy is never
    pulled over a file readers hold open."""
    info = load_volume_info(vif_path(volume))
    if not info or "remote" not in info:
        raise VolumeError(f"volume {volume.id} has no remote tier")
    remote = info["remote"]
    backend = get_backend(remote["backend"])

    with volume.lock:
        already_local = (os.path.exists(volume.dat_path)
                         and not isinstance(volume.dat, RemoteFile))
        if already_local:
            size = os.path.getsize(volume.dat_path)
            os.remove(vif_path(volume))
    if already_local:
        if delete_remote:
            backend.delete(remote["key"])
        return {"volume": volume.id, "size": size, "already_local": True}

    tmp = volume.dat_path + ".tierdl"
    try:
        got = backend.download_file(remote["key"], tmp)
        if got != remote["file_size"]:
            raise VolumeError(
                f"tier download size mismatch: {got} != "
                f"{remote['file_size']}")
        with volume.lock:
            os.replace(tmp, volume.dat_path)
            volume.dat.close()
            volume.dat = open(volume.dat_path, "r+b")
            os.remove(vif_path(volume))
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    if delete_remote:
        backend.delete(remote["key"])
    return {"volume": volume.id, "size": got}
