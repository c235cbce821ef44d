"""``weed benchmark``: the cluster load generator.

The JAX package's ``command/benchmark.py`` (reference
weed/command/benchmark.go; its README's throughput figures come from
this tool):

- ``run_benchmark``: ``concurrency`` threads assign and upload
  ``num_files`` files of ``file_size`` bytes (``assign_batch`` files per
  assign; a write token drops it to one), then read them back in a
  seeded random order; each phase reports requests, failures, req/s,
  KB/s and the latency percentiles (``Stats.report``). The payload and
  the read order come from ``numpy.random.default_rng(0)``.
- ``run_native_benchmark``: a pool of assigned fids driven by the
  port's keep-alive load generator (``csrc/loadgen.cc``, built by
  ``server/native_plane.build_loadgen``), a POST phase then a GET phase
  against each volume server's advertised address, ``concurrency``
  connections split among them; one report and one JSON line a phase.

Both speak to the cluster through ``client/operation`` and so through
the process's TLS (``server/http_util``). The load generator speaks
plain HTTP.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import List

import numpy as np

from ..client import operation as op
from ..server.http_util import HttpError
from ..util.locks import make_lock


class Stats:
    def __init__(self):
        self.latencies: List[float] = []
        self.failed = 0
        self.bytes = 0
        self.lock = make_lock("torch.benchmark.lock")

    def add(self, dt: float, nbytes: int):
        with self.lock:
            self.latencies.append(dt)
            self.bytes += nbytes

    def fail(self):
        with self.lock:
            self.failed += 1

    def report(self, title: str, wall: float, out):
        lat = sorted(self.latencies)
        n = len(lat)
        print(f"\n--- {title} ---", file=out)
        print(f"requests: {n} ok, {self.failed} failed in {wall:.3f}s",
              file=out)
        if not n:
            return
        print(f"throughput: {n / wall:.2f} req/s, "
              f"{self.bytes / wall / 1024:.2f} KB/s", file=out)
        for p in (50, 75, 90, 95, 99):
            print(f"  p{p}: {lat[min(n - 1, n * p // 100)] * 1000:.1f} ms",
                  file=out)
        print(f"  max: {lat[-1] * 1000:.1f} ms", file=out)


def run_benchmark(master_url: str, num_files: int = 1024,
                  file_size: int = 1024, concurrency: int = 16,
                  collection: str = "benchmark", write: bool = True,
                  read: bool = True, assign_batch: int = 1, out=None):
    """Write ``num_files`` files, then read as many at random; the fids
    written."""
    out = out or sys.stdout
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, file_size).astype(np.uint8).tobytes()
    fids: List[str] = []
    fid_lock = make_lock("torch.benchmark.fid_lock")

    if write:
        stats = Stats()

        def worker_count(wid: int) -> int:
            # the remainder spread so that exactly num_files are written
            return num_files // concurrency + \
                (1 if wid < num_files % concurrency else 0)

        def writer(wid: int):
            # one assign for a batch of keys (fid, fid_1, ...): the
            # assign's round trip is charged to the batch's first file
            remaining = worker_count(wid)
            batch = max(1, assign_batch)
            seq = 0
            while remaining > 0:
                t_assign = time.perf_counter()
                try:
                    a = op.assign(master_url,
                                  count=min(batch, remaining),
                                  collection=collection)
                except HttpError:
                    stats.fail()
                    remaining -= 1
                    continue
                granted = max(1, min(int(a.get("count", 1)), remaining))
                if a.get("auth"):
                    # a write token is bound to one fid: one file an
                    # assign from here on
                    granted = 1
                    batch = 1
                target = a.get("fastUrl") or a["url"]
                for i, fid in enumerate(
                        op.expand_batch_fids(a["fid"], granted)):
                    t = t_assign if i == 0 else time.perf_counter()
                    try:
                        op.upload(target, fid, payload,
                                  filename=f"b{wid}_{seq}",
                                  jwt=a.get("auth", ""))
                        stats.add(time.perf_counter() - t, file_size)
                        with fid_lock:
                            fids.append(fid)
                    except HttpError:
                        stats.fail()
                    seq += 1
                remaining -= granted

        t0 = time.perf_counter()
        threads = [threading.Thread(target=writer, args=(w,),
                                    name=f"bench-writer-{w}")
                   for w in range(concurrency)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        stats.report("write", time.perf_counter() - t0, out)

    if read and fids:
        stats = Stats()
        cache = op.VidCache(master_url)
        idx_seq = rng.integers(0, len(fids), len(fids))
        chunks = np.array_split(idx_seq, concurrency)

        def reader(idxs):
            for i in idxs:
                fid = fids[int(i)]
                t = time.perf_counter()
                try:
                    data = op.read_file(master_url, fid, cache)
                    stats.add(time.perf_counter() - t, len(data))
                except HttpError:
                    stats.fail()

        t0 = time.perf_counter()
        threads = [threading.Thread(target=reader, args=(c,),
                                    name=f"bench-reader-{n}")
                   for n, c in enumerate(chunks)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        stats.report("random read", time.perf_counter() - t0, out)
    return fids


def run_native_benchmark(master_url: str, file_size: int = 1024,
                         concurrency: int = 16,
                         collection: str = "benchmark",
                         seconds: float = 10.0, pool: int = 4096,
                         assign_batch: int = 256, out=None):
    """``weed benchmark -native``: what the servers take rather than
    what one Python client can push. A pool of ``pool`` fids is
    assigned in batches, grouped by the server each names; the load
    generator then writes them (POST mode, each path once or until
    ``seconds`` run out) and reads them back (GET mode, ``seconds``).
    The read phase's errors."""
    from ..server.native_plane import build_loadgen
    out = out or sys.stdout
    binary = str(build_loadgen())

    targets = {}  # (host, port) -> [paths]
    assigned = 0
    assign_failures = 0
    while assigned < pool:
        try:
            a = op.assign(master_url,
                          count=min(assign_batch, pool - assigned),
                          collection=collection)
        except HttpError as e:
            assign_failures += 1
            if assign_failures > 5:
                raise RuntimeError(
                    f"assign pool: {assign_failures} consecutive "
                    f"failures, giving up: {e}") from e
            time.sleep(0.2 * assign_failures)
            continue
        assign_failures = 0
        if a.get("auth"):
            raise SystemExit(
                "benchmark -native does not speak per-fid write JWTs; "
                "run it against a cluster without -jwtKey")
        granted = max(1, min(int(a.get("count", 1)), pool - assigned))
        url = a.get("fastUrl") or a["url"]
        host, _, port = url.rpartition(":")
        host = host.strip("[]") or "127.0.0.1"
        # the load generator dials IPv4 addresses
        try:
            host = socket.getaddrinfo(host, int(port), socket.AF_INET,
                                      socket.SOCK_STREAM)[0][4][0]
        except socket.gaierror as e:
            raise RuntimeError(
                f"benchmark -native needs an IPv4 route to {host!r} "
                f"(the native engine dials IPv4): {e}") from e
        bucket = targets.setdefault((host, int(port)), [])
        for fid in op.expand_batch_fids(a["fid"], granted):
            bucket.append("/" + fid)
        assigned += granted

    def thread_split() -> dict:
        """``concurrency`` connections (at least one a target), split by
        pooled paths, largest remainders first."""
        items = list(targets.items())
        total_paths = sum(len(p) for _, p in items)
        want = max(len(items), concurrency)
        extra = want - len(items)
        shares = [(key, len(paths) * extra / total_paths)
                  for key, paths in items]
        alloc = {key: 1 + int(s) for key, s in shares}
        left = want - sum(alloc.values())
        for key, s in sorted(shares, key=lambda kv: kv[1] - int(kv[1]),
                             reverse=True):
            if left <= 0:
                break
            alloc[key] += 1
            left -= 1
        return alloc

    def drive(phase_args, label):
        """One load generator a target, all at once."""
        procs = []
        alloc = thread_split()
        tmpdir = tempfile.mkdtemp(prefix="weedbench")
        requests = errors = 0
        wall = 0.0
        try:
            for n, ((host, port), paths) in enumerate(targets.items()):
                pf = os.path.join(tmpdir, f"paths{n}")
                with open(pf, "w") as f:
                    f.write("\n".join(paths))
                procs.append(subprocess.Popen(
                    [binary, host, str(port), str(seconds),
                     str(alloc[(host, port)]), pf] + phase_args,
                    stdout=subprocess.PIPE, text=True))
            for p in procs:
                stdout, _ = p.communicate(timeout=seconds + 60)
                if p.returncode != 0:
                    raise RuntimeError(f"loadgen exited {p.returncode}")
                r = json.loads(stdout)
                requests += r["requests"]
                errors += r["errors"]
                wall = max(wall, r["seconds"])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            shutil.rmtree(tmpdir, ignore_errors=True)
        rps = requests / wall if wall else 0.0
        conns = sum(alloc.values())
        print(f"\n--- native {label}: {len(targets)} target(s), "
              f"{conns} connections ---", file=out)
        print(f"requests: {requests}  errors: {errors}", file=out)
        print(f"time taken: {wall:.2f}s  req/s: {rps:.1f}  "
              f"KB/s: {rps * file_size / 1024:.1f}", file=out)
        print(json.dumps({"phase": label, "requests": requests,
                          "errors": errors, "seconds": round(wall, 3),
                          "rps": round(rps, 1), "connections": conns,
                          "targets": len(targets)}), file=out)
        return requests, errors

    drive(["post", str(file_size)], "write")
    # a path the write phase did not reach reads as an error
    _, read_errors = drive([], "random read")
    return read_errors
