"""The SW_* environment knobs the port reads, with typed accessors.

The JAX package's ``util/config.py`` registry, for the knobs of the
native data plane and the filer (names, types and defaults as there, so
one ``monkeypatch.setenv`` sets a knob for both packages):

    SW_HTTP_PLANE_LIB           the plane's shared library, in place of
                                the one built from csrc/http_plane.cc
                                (it must exist when set)
    SW_PLANE_STATS              the plane's counters, latency histogram
                                and slow ring (on)
    SW_PLANE_SLOW_US            the slow ring's threshold (10000 us)
    SW_PLANE_CACHE_BYTES        the reconstructed-slab cache's budget
                                (32 MiB; 0 sends every read through a
                                lost shard to Python)
    SW_PLANE_FSYNC_MODE         off | group | always: the durability of
                                an acknowledged append, the plane's and
                                the Python path's (off)
    SW_PLANE_FSYNC_BATCH_US     a group commit's window (2000 us)
    SW_PLANE_FSYNC_MAX_PENDING  riders that close a window early (512)
    SW_FILER_TICK_S             the filer's deletion loop's period (1.0 s)
    SW_RETRY_BACKOFF_SCALE      a multiplier on retry back-offs (uploads,
                                chunk fetches): ``retry_backoff_s``; 0
                                retries at once (1.0)
    SW_REPAIR_INTERVAL_S        the repair loop's period of a master the
                                CLI starts (5.0 s; <= 0: no loop)

A read of a name that is not registered, or as another type than its
own, raises. The full registry (every knob of the JAX package) is not
ported.

The config-file tier of the JAX module (reference util/config.go and
scaffold.go): ``load_config(name)`` reads ``<name>.toml`` (stdlib
``tomllib``) or ``<name>.json`` from the first of ``SEARCH_DIRS`` that
holds one (the JAX package's directories, so one file configures both),
flattens it to dotted lower-case keys, and lays every ``WEED_*``
environment variable on top (``WEED_JWT_SIGNING_KEY`` is
``jwt.signing.key``); ``config_get`` reads a dotted key, taking ``_``
and ``.`` as one. The CLI reads ``security`` and ``master`` through
them (``command/scaffold`` prints examples of every file).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, NamedTuple, Optional

SEARCH_DIRS = [".", os.path.expanduser("~/.seaweedfs_tpu"),
               "/etc/seaweedfs_tpu"]
ENV_PREFIX = "WEED_"


class EnvKnob(NamedTuple):
    name: str
    kind: str
    default: object


KNOBS: Dict[str, EnvKnob] = {k.name: k for k in (
    EnvKnob("SW_HTTP_PLANE_LIB", "str", None),
    EnvKnob("SW_PLANE_STATS", "bool", True),
    EnvKnob("SW_PLANE_SLOW_US", "int", 10000),
    EnvKnob("SW_PLANE_CACHE_BYTES", "int", 32 << 20),
    EnvKnob("SW_PLANE_FSYNC_MODE", "str", "off"),
    EnvKnob("SW_PLANE_FSYNC_BATCH_US", "int", 2000),
    EnvKnob("SW_PLANE_FSYNC_MAX_PENDING", "int", 512),
    EnvKnob("SW_FILER_TICK_S", "float", 1.0),
    EnvKnob("SW_RETRY_BACKOFF_SCALE", "float", 1.0),
    EnvKnob("SW_REPAIR_INTERVAL_S", "float", 5.0),
)}

_TRUTHY = ("1", "true", "yes", "on")


def _lookup(name: str, kind: str):
    knob = KNOBS.get(name)
    if knob is None:
        raise KeyError(f"env knob {name} is not registered")
    if knob.kind != kind:
        raise TypeError(f"env knob {name} is registered as {knob.kind}, "
                        f"read as {kind}")
    return os.environ.get(name), knob.default


def env_str(name: str) -> Optional[str]:
    raw, default = _lookup(name, "str")
    return raw if raw is not None else default


def env_int(name: str) -> Optional[int]:
    raw, default = _lookup(name, "int")
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def env_float(name: str) -> Optional[float]:
    raw, default = _lookup(name, "float")
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def env_bool(name: str) -> bool:
    raw, default = _lookup(name, "bool")
    if raw is None:
        return bool(default)
    return raw.strip().lower() in _TRUTHY


def retry_backoff_s(seconds: float) -> float:
    """A retry back-off of ``seconds``, scaled by SW_RETRY_BACKOFF_SCALE."""
    return max(0.0, seconds * env_float("SW_RETRY_BACKOFF_SCALE"))


def env_is_set(name: str) -> bool:
    """Whether the registered knob is set in the environment."""
    _lookup(name, KNOBS[name].kind if name in KNOBS else "str")
    return name in os.environ


def _flatten(d: dict, prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    for k, v in d.items():
        key = f"{prefix}{k}".lower()
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def find_config_file(name: str,
                     dirs: Optional[List[str]] = None) -> Optional[str]:
    """The first ``<dir>/<name>.toml`` or ``.json`` of ``dirs``
    (``SEARCH_DIRS`` by default), else None."""
    for d in dirs or SEARCH_DIRS:
        for ext in (".toml", ".json"):
            p = os.path.join(d, name + ext)
            if os.path.isfile(p):
                return p
    return None


def load_config(name: str, dirs: Optional[List[str]] = None,
                env: Optional[dict] = None) -> Dict[str, object]:
    """The flattened dotted-key config of ``name``, {} when no file
    exists; ``WEED_*`` variables of ``env`` (the process environment by
    default) apply on top, so a config can be environment alone."""
    cfg: Dict[str, object] = {}
    path = find_config_file(name, dirs)
    if path is not None:
        if path.endswith(".toml"):
            import tomllib
            with open(path, "rb") as f:
                cfg = _flatten(tomllib.load(f))
        else:
            with open(path) as f:
                cfg = _flatten(json.load(f))
    environ = os.environ if env is None else env
    for k, v in environ.items():
        if k.startswith(ENV_PREFIX):
            cfg[k[len(ENV_PREFIX):].lower().replace("_", ".")] = v
    return cfg


def config_get(cfg: Dict[str, object], key: str, default=None):
    """A dotted key of ``cfg``; ``_`` and ``.`` are one (an environment
    variable cannot carry a dot: ``WEED_SECURITY_JWT_KEY`` and
    ``[security] jwt_key`` land on one value)."""
    key = key.lower()
    if key in cfg:
        return cfg[key]
    return cfg.get(key.replace("_", "."), default)
