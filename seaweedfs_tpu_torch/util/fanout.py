"""Parallel fan-out over cluster peers: every target runs at once and the
caller gets (item, result, exception) per target, in input order. The
replica fan-out of a write or a delete rides one long-lived shared pool
(threads named ``fanout``); the shell's rare long copies take a pool of
their own (``dedicated=True``) so they cannot block that hot path. The
JAX package's ``util/fanout.py``."""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Sequence, Tuple, TypeVar

T = TypeVar("T")
R = TypeVar("R")

_MAX_WORKERS = 32
_pool = None
_pool_lock = threading.Lock()


def _shared_pool() -> ThreadPoolExecutor:
    """The one shared pool; callables must not fan out again inside it."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max_workers=_MAX_WORKERS,
                                       thread_name_prefix="fanout")
        return _pool


def fan_out(fn: Callable[[T], R], items: Sequence[T],
            dedicated: bool = False) -> List[Tuple[T, R, Exception]]:
    """Run ``fn(item)`` for every item at once. Returns
    [(item, result, None) | (item, None, exc)] in input order; zero or one
    item runs on the caller's thread."""
    items = list(items)
    if not items:
        return []
    if len(items) == 1:
        try:
            return [(items[0], fn(items[0]), None)]
        except Exception as e:  # noqa: BLE001 - relayed to the caller
            return [(items[0], None, e)]
    out: List[Tuple[T, R, Exception]] = [None] * len(items)  # type: ignore

    def run(i: int):
        try:
            out[i] = (items[i], fn(items[i]), None)
        except Exception as e:  # noqa: BLE001 - relayed to the caller
            out[i] = (items[i], None, e)

    if dedicated:
        with ThreadPoolExecutor(max_workers=min(_MAX_WORKERS,
                                                len(items))) as ex:
            list(ex.map(run, range(len(items))))
    else:
        list(_shared_pool().map(run, range(len(items))))
    return out


def fan_out_must_succeed(fn: Callable[[T], R], items: Sequence[T],
                         what: str = "operation",
                         ok: Callable[[Exception], bool] = None,
                         dedicated: bool = False) -> List[R]:
    """All must succeed: raises RuntimeError naming every failed target;
    ``ok(exc)`` may let a benign failure pass (a 404 on a replica
    delete: already gone)."""
    failed = []
    results = []
    for item, result, exc in fan_out(fn, items, dedicated=dedicated):
        if exc is not None and not (ok is not None and ok(exc)):
            failed.append(f"{item}: {exc}")
        else:
            results.append(result)
    if failed:
        raise RuntimeError(f"{what} failed on " + "; ".join(failed))
    return results
