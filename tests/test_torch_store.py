"""The port's network rebuild (``storage/store.Store.rebuild_ec_shards_streaming``,
``ec.rebuild -repair auto|trace|piggyback|full``) against the JAX
package's Store, both pulling survivors over HTTP from the same port
holders on localhost (CPU, RS(10,4), a 4 KiB piggyback window).

Three holders serve a flat volume 1 and a piggyback volume 2: holder a
shards 0-4, holder b 5-9 plus 0 and 1 (two holders for those, so the
rotation splits them), holder c 10-13; an "old" holder serves every
shard but has no repair routes. Each case runs the JAX Store (NumpyCodec)
and the port's (TorchCodec on the CPU, the plain K1) over empty
directories of their own, and compares the rebuilt shards, the route
taken (``repair_mode``), the fallback reason, ``repair_bytes_frac``,
the remote bytes, the per-holder fetches and every forced-mode
``VolumeError`` text. Also the health-routed survivor choice
(``health_demoted_shards``), mirroring tests/test_fleet_health.py."""

import os

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import codec as ref_codec
from seaweedfs_tpu.stats import health as ref_health
from seaweedfs_tpu.storage import store as ref_store
from seaweedfs_tpu_torch.ec import to_ext
from seaweedfs_tpu_torch.ops import codec as port_codec
from seaweedfs_tpu_torch.ops.rs_torch import TorchCodec
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.stats import health
from seaweedfs_tpu_torch.storage import store

K, M = 10, 4
TOTAL = K + M
W = 40_003           # flat shard width (volume 1)
WINDOW = 4096        # piggyback window (volume 2, alpha 32)
PB_W = 12 * WINDOW   # piggyback shard width
SLAB = 16 << 10      # stripe width (4 windows)
HOLDS = {"a": range(0, 5), "b": [0, 1] + list(range(5, 10)),
         "c": range(10, 14)}
#: stats both stores report that must agree
KEYS = ("repair_mode", "repair_fallback", "repair_bytes_frac",
        "repair_bytes", "repair_remote_bytes", "gather_bytes",
        "gather_remote_bytes", "gather_fetches", "gather_stripes",
        "gather_retries", "gather_remote_shards", "holder_fetches",
        "holder_errors", "survivor_bytes", "rebuilt_bytes",
        "health_demoted_shards", "peak_gather_buffer")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain K1 runs hundreds of small torch ops a stripe; with the
    suite's workers sharing the cores, intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seed(directory, seed=11):
    """Flat volume 1 and piggyback volume 2 with .ecx and .vif;
    returns {vid: (14, w) shards}."""
    from seaweedfs_tpu.ec import layout as ref_layout
    os.makedirs(directory)
    rng = np.random.default_rng(seed)
    flat = ref_codec.NumpyCodec(K, M).encode_to_all(
        rng.integers(0, 256, (K, W), dtype=np.uint8))
    pplan = ref_codec.piggyback_plan(K, M)
    data = rng.integers(0, 256, (K, PB_W), dtype=np.uint8)
    pb = np.concatenate([data, ref_codec.pb_merge(
        ref_codec.host_matmul(pplan.emat,
                              ref_codec.pb_split(data, pplan.alpha, WINDOW)),
        pplan.alpha, WINDOW)])
    for vid, shards in ((1, flat), (2, pb)):
        base = os.path.join(directory, str(vid))
        for i in range(TOTAL):
            shards[i].tofile(base + to_ext(i))
        with open(base + ".ecx", "wb") as f:
            f.write(rng.bytes(16 * 6))
        ref_layout.write_layout_sidecars(
            base, "piggyback" if vid == 2 else "flat", WINDOW,
            pplan.npairs, version=3, offset_width=4)
    return {1: flat, 2: pb}


def _holder_dir(src, dst, sids):
    os.makedirs(dst)
    for vid in (1, 2):
        names = [f"{vid}.ecx", f"{vid}.vif"] + \
            [f"{vid}{to_ext(i)}" for i in sids]
        for name in names:
            os.link(os.path.join(src, name), os.path.join(dst, name))


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cluster"))
    src = os.path.join(root, "src")
    shards = _seed(src)
    servers = {}
    for name, sids in list(HOLDS.items()) + [("old", range(TOTAL))]:
        _holder_dir(src, os.path.join(root, name), sids)
        servers[name] = VolumeServer(port=0, directories=[
            os.path.join(root, name)], fast_port=-1).start()
    # an old holder: the shard and file routes, no repair routes
    router = servers["old"].server.router
    router.routes = [r for r in router.routes
                     if r[1] in ("/admin/ec/shard_read", "/admin/file")]
    yield servers, shards
    for vs in servers.values():
        vs.stop()


def _sources(servers, lost, old=False):
    if old:
        return {i: [servers["old"].url] for i in range(TOTAL)
                if i not in lost}
    return {i: [servers[h].url for h in HOLDS if i in HOLDS[h]]
            for i in range(TOTAL) if i not in lost}


def _rebuild_one(d, side, sources, vid, mode, routing=False):
    """(rebuilt or None, error text or None, stats, {sid: bytes}) of the
    JAX Store (``side="ref"``) or the port's over the empty directory d."""
    d.mkdir()
    if side == "ref":
        st = ref_store.Store([str(d)], codec=ref_codec.NumpyCodec(K, M))
    else:
        st = store.Store([str(d)], codec=TorchCodec(K, M, device="cpu"),
                         routing=routing)
    stats, got, err = {}, None, None
    try:
        got = st.rebuild_ec_shards_streaming(
            vid, sources=sources, stats=stats, slab=SLAB, window=2,
            repair=mode)
    except (ref_store.VolumeError, store.VolumeError) as e:
        err = str(e)
    files = {int(f.split(".ec")[1]): open(d / f, "rb").read()
             for f in sorted(os.listdir(d))
             if ".ec" in f and f.split(".ec")[1].isdigit()}
    return got, err, stats, files


def _rebuild_both(tmp_path, sources, vid, mode):
    return [_rebuild_one(tmp_path / side, side, sources, vid, mode)
            for side in ("ref", "port")]


def _check(results, shards, vid, lost, keys=KEYS):
    (ref_got, ref_err, ref_st, ref_files), (got, err, st, files) = results
    assert (got, err) == (ref_got, ref_err)
    assert files == ref_files
    for key in keys:
        assert st.get(key) == ref_st.get(key), key
    if err is None:
        assert sorted(files) == sorted(got) == sorted(lost)
        for sid in lost:
            assert files[sid] == shards[vid][sid].tobytes()
    return st, err


# (id, vid, lost, mode, old holder)
CASES = [
    ("flat-auto-1", 1, (10,), "auto", False),
    ("flat-trace-1", 1, (3,), "trace", False),
    ("flat-full-1", 1, (3,), "full", False),
    ("flat-auto-4", 1, (0, 5, 8, 13), "auto", False),
    ("flat-trace-4", 1, (0, 5, 8, 13), "trace", False),
    ("flat-piggyback", 1, (3,), "piggyback", False),
    ("flat-bad-mode", 1, (3,), "bogus", False),
    ("flat-too-few", 1, (0, 1, 2, 3, 4), "auto", False),
    ("flat-none-lost", 1, (), "auto", False),
    ("pb-auto-1", 2, (5,), "auto", False),
    ("pb-piggyback-1", 2, (2,), "piggyback", False),
    ("pb-full-1", 2, (5,), "full", False),
    ("pb-auto-parity", 2, (12,), "auto", False),
    ("pb-piggyback-parity", 2, (12,), "piggyback", False),
    ("pb-auto-4", 2, (0, 7, 11, 12), "auto", False),
    ("pb-trace", 2, (5,), "trace", False),
    ("old-flat-auto", 1, (3,), "auto", True),
    ("old-flat-trace", 1, (3,), "trace", True),
    ("old-pb-auto", 2, (5,), "auto", True),
    ("old-pb-piggyback", 2, (5,), "piggyback", True),
]


@pytest.mark.parametrize("vid,lost,mode,old", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_rebuild_matches_jax(cluster, tmp_path, vid, lost, mode, old):
    servers, shards = cluster
    results = _rebuild_both(tmp_path, _sources(servers, lost, old), vid,
                            mode)
    st, err = _check(results, shards, vid, lost)
    size = W if vid == 1 else PB_W
    if err is not None:
        assert err.startswith(("-repair", "unknown repair mode",
                               "cannot rebuild"))
        return
    if not lost:
        return
    if st["repair_mode"] == "trace":
        plan = port_codec.repair_plan(
            K, M, lost[0], survivors=[i for i in range(TOTAL)
                                      if i not in lost])
        symbols = plan.total_bits * sum(
            (min(SLAB, size - off) + 7) // 8 for off in range(0, size, SLAB))
        assert st["gather_remote_bytes"] == symbols
        assert st["repair_bytes_frac"] == round(symbols / (K * size), 4)
    elif st["repair_mode"] == "piggyback":
        assert st["repair_bytes_frac"] == 0.55
        assert st["gather_remote_bytes"] == (K + 1) * size // 2
    else:
        assert st["repair_mode"] == "full"
        assert st["gather_remote_bytes"] == K * size
    if old:
        assert st["repair_mode"] == "full"
        assert st["repair_fallback"].startswith("holder refused")
    if (vid, lost, mode) == (1, (10,), "auto"):
        # shards 0 and 1 rotate between their two holders
        a, b = servers["a"].url, servers["b"].url
        assert st["holder_fetches"][a] > 0 and st["holder_fetches"][b] > 0


def test_forced_mode_errors_name_the_reason(cluster, tmp_path):
    """The forced-mode texts, each the JAX package's."""
    servers, _ = cluster
    want = {
        ("trace", 1, (0, 5, 8, 13), False):
            "-repair trace: 4 shards lost, trace repairs one",
        ("trace", 1, (3,), True):
            "-repair trace: holder refused repair read (404)",
        ("piggyback", 2, (5,), True):
            "-repair piggyback: holder refused plane read (404)",
        ("piggyback", 2, (12,), False):
            "-repair piggyback: shard 12 not coupled (coupled prefix is "
            "0..9)",
    }
    for n, ((mode, vid, lost, old), text) in enumerate(want.items()):
        d = tmp_path / str(n)
        d.mkdir()
        st = store.Store([str(d)], codec=TorchCodec(K, M, device="cpu"))
        with pytest.raises(store.VolumeError) as ei:
            st.rebuild_ec_shards_streaming(
                vid, sources=_sources(servers, lost, old), slab=SLAB,
                repair=mode)
        assert str(ei.value) == text


def _feed(board, slow, fast):
    board.reset()
    for _ in range(10):
        board.record_latency(slow, "shard_read", 0.5)
        board.record_latency(fast, "shard_read", 0.001)


def test_health_survivor_mask_matches_jax(monkeypatch):
    monkeypatch.setenv("SW_EC_HEALTH_ROUTING", "1")
    _feed(ref_health.BOARD, "slow:1", "fast:2")
    _feed(health.BOARD, "slow:1", "fast:2")
    try:
        total, k = 6, 4
        present = [True] * total
        local = [False] * total
        sources = {0: ["slow:1"], 1: ["fast:2"], 2: ["slow:1"],
                   3: ["fast:2"], 4: ["slow:1"], 5: ["fast:2"]}
        got = []
        for mask, kw in ((ref_store.Store._health_survivor_mask, {}),
                         (store.Store._health_survivor_mask,
                          {"routing": True})):
            stats = {}
            got.append((mask(present, local, sources, k, stats, **kw),
                        stats))
        assert got[1] == got[0]
        assert got[1][1]["health_demoted_shards"] == [2, 4]
        # routing off (the default), or no surplus: untouched
        assert store.Store._health_survivor_mask(
            present, local, sources, k, {}) is present
        assert store.Store._health_survivor_mask(
            present, local, sources, total, {}, routing=True) is present
    finally:
        ref_health.BOARD.reset()
        health.BOARD.reset()


def test_health_routed_full_rebuild_matches_jax(cluster, tmp_path,
                                                monkeypatch):
    """With holder c scored slow on both boards, the full rebuild of one
    lost shard drops the surplus survivors that only c holds, and the
    rebuilt bytes do not change."""
    servers, shards = cluster
    monkeypatch.setenv("SW_EC_HEALTH_ROUTING", "1")
    slow, fast = servers["c"].url, servers["a"].url
    try:
        results = []
        for side, board in (("ref", ref_health.BOARD),
                            ("port", health.BOARD)):
            _feed(board, slow, fast)
            results.append(_rebuild_one(tmp_path / side, side,
                                        _sources(servers, (4,)), 1, "full",
                                        routing=True))
        # with routing on, each read's own latency reorders the two
        # holders of shards 0 and 1, so their split is the clock's
        st, _ = _check(results, shards, 1, (4,),
                       keys=[key for key in KEYS if key != "holder_fetches"])
        # 13 survivors for k = 10: the three highest of c's four go, and
        # c serves only shard 10, once a stripe
        assert st["health_demoted_shards"] == [11, 12, 13]
        assert st["holder_fetches"][slow] == st["gather_stripes"]
    finally:
        ref_health.BOARD.reset()
        health.BOARD.reset()
