"""The port's tuning layer (``repro_torch.tuning``) held against the JAX
package's (``repro.tuning``): the persisted TuningCache and its contracts,
the single-flight ``tune()`` sweep with fake runners, the bucket-edge
ladders, and the cost model.

Parity with the reference, on the same inputs: the ``cpu`` profile's
analytic counts, per-signal costs and edge density equal the reference's
exactly; the three ladders give the same edges over 1..2**20 (and so the
same rounding); a cache file written by either package loads in the other
with every entry kept.  What is the port's own: the launch shapes its
entries hold (``idct_rw``, ``v3_tile_windows``, ``levels_rw``), which are
legal only where the CUDA launchers accept them, and the sweeps, which
need the card.
"""
import json
import threading
import time

import pytest

pytest.importorskip("jax")  # the reference; absent on the card

import numpy as np  # noqa: E402

from repro.tuning import autotune as ref_autotune  # noqa: E402
from repro.tuning import cost_model as ref_cost_model  # noqa: E402
from repro.tuning import policy as ref_policy  # noqa: E402
from repro_torch.kernels import tiles  # noqa: E402
from repro_torch.tuning import autotune  # noqa: E402
from repro_torch.tuning.autotune import (  # noqa: E402
    CACHE_VERSION,
    BlockMemo,
    TuningCache,
    blocks_legal,
    decode_block_candidates,
    encode_block_candidates,
    epoch,
    set_default_cache,
    tune,
    tuned_blocks,
)
from repro_torch.tuning.cost_model import (  # noqa: E402
    CostModel,
    default_cost_model,
)
from repro_torch.tuning.policy import (  # noqa: E402
    COST_BALANCED,
    HALF_OCTAVE,
    P2,
    POLICY_NAMES,
    BucketPolicy,
    cost_balanced_policy,
)

# a legal decode entry (N = 32, E = 6, l_max 12, 8 symbols a word) and a
# legal encode entry (N = 32, E = 6, chunk 64)
DEC = (32, 6, 12, 8)
ENC = (32, 6, 64)


# ---------------------------------------------------------------------------
# TuningCache: store/lookup, persistence, rejection of bad state.
# ---------------------------------------------------------------------------
def test_cache_roundtrip_and_persistence(tmp_path):
    cache = TuningCache(str(tmp_path))
    assert cache.lookup("decode", "cpu", DEC, (1024, 256)) is None
    cache.store("decode", "cpu", DEC, (1024, 256), {"idct_rw": 4})
    assert cache.lookup("decode", "cpu", DEC, (1024, 256)) == {"idct_rw": 4}
    # a different shape is a different entry
    assert cache.lookup("decode", "cpu", DEC, (2048, 256)) is None

    # a fresh instance reads the persisted file
    again = TuningCache(str(tmp_path))
    assert len(again) == 1
    assert again.lookup("decode", "cpu", DEC, (1024, 256)) == {"idct_rw": 4}
    with open(cache.path) as f:
        data = json.load(f)
    assert data["version"] == CACHE_VERSION == ref_autotune.CACHE_VERSION


def test_cache_memory_only_without_directory(monkeypatch):
    monkeypatch.delenv("FPTC_TUNING_CACHE", raising=False)
    cache = TuningCache()
    assert cache.path is None
    cache.store("encode", "cpu", ENC, (8, 1024), {"levels_rw": 2})
    assert cache.lookup("encode", "cpu", ENC, (8, 1024)) == {"levels_rw": 2}


def test_corrupt_cache_file_rejected_not_trusted(tmp_path):
    path = tmp_path / "fptc_tuning.json"
    path.write_text("{ not json !!!")
    cache = TuningCache(str(tmp_path))
    assert cache.lookup("decode", "cpu", (32,), (64,)) is None  # no raise
    # the cache stays writable and overwrites the corrupt file
    cache.store("decode", "cpu", (32,), (64,), {"idct_rw": 8})
    again = TuningCache(str(tmp_path))
    assert again.lookup("decode", "cpu", (32,), (64,)) == {"idct_rw": 8}


def test_stale_schema_version_rejected_wholesale(tmp_path):
    path = tmp_path / "fptc_tuning.json"
    path.write_text(json.dumps({
        "version": CACHE_VERSION + 999,
        "entries": {
            "decode|cpu|plan(32)|shape(64)": {"blocks": {"idct_rw": 8}}
        },
    }))
    cache = TuningCache(str(tmp_path))
    assert len(cache) == 0
    assert cache.lookup("decode", "cpu", (32,), (64,)) is None


def test_invalid_entries_dropped_and_retuned(tmp_path):
    path = tmp_path / "fptc_tuning.json"
    path.write_text(json.dumps({
        "version": CACHE_VERSION,
        "entries": {
            # block value 0, a string, a bool, and a missing map
            "decode|cpu|plan(1)|shape(1)": {"blocks": {"idct_rw": 0}},
            "decode|cpu|plan(2)|shape(2)": {"blocks": {"idct_rw": "x"}},
            "decode|cpu|plan(3)|shape(3)": {"blocks": {"idct_rw": True}},
            "decode|cpu|plan(4)|shape(4)": {},
            "decode|cpu|plan(5)|shape(5)": {"blocks": {"idct_rw": 8}},
        },
    }))
    cache = TuningCache(str(tmp_path))
    assert len(cache) == 1  # only the valid entry survives the load
    for plan in (1, 2, 3, 4):
        assert cache.lookup("decode", "cpu", (plan,), (plan,)) is None
    assert cache.lookup("decode", "cpu", (5,), (5,)) == {"idct_rw": 8}


def test_store_refuses_invalid_blocks(tmp_path):
    cache = TuningCache(str(tmp_path))
    for bad in ({}, {"idct_rw": 0}, {"idct_rw": "big"}, "nope"):
        with pytest.raises((ValueError, TypeError)):
            cache.store("decode", "cpu", (1,), (1,), bad)
    assert len(cache) == 0


def test_store_bumps_epoch(tmp_path):
    cache = TuningCache(str(tmp_path))
    e0 = epoch()
    cache.store("decode", "cpu", (1,), (1,), {"idct_rw": 8})
    assert epoch() > e0


def test_concurrent_readers_and_writers_safe(tmp_path):
    """N reader threads race a writer through lookup/store with file IO
    underneath — no exceptions, and every observed value is a stored
    one."""
    cache = TuningCache(str(tmp_path))
    cache.store("decode", "cpu", (0,), (0,), {"v3_tile_windows": 1})
    errors = []
    seen = set()
    stop = threading.Event()

    def reader():
        try:
            while not stop.is_set():
                got = cache.lookup("decode", "cpu", (0,), (0,))
                if got is not None:
                    seen.add(got["v3_tile_windows"])
        except Exception as exc:  # pragma: no cover - the failure signal
            errors.append(exc)

    def writer():
        try:
            for i in range(1, 50):
                cache.store("decode", "cpu", (0,), (0,),
                            {"v3_tile_windows": i})
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    readers = [threading.Thread(target=reader) for _ in range(4)]
    w = threading.Thread(target=writer)
    for t in readers:
        t.start()
    w.start()
    w.join(30)
    stop.set()
    for t in readers:
        t.join(30)
    assert not w.is_alive() and not any(t.is_alive() for t in readers)
    assert not errors
    assert seen <= set(range(1, 50))
    # the persisted file is whole and valid after the race (atomic replace)
    again = TuningCache(str(tmp_path))
    assert again.lookup("decode", "cpu", (0,), (0,)) == {
        "v3_tile_windows": 49}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cache_files_interchange(tmp_path, writer):
    """A cache file written by one package loads in the other, which keeps
    the writer's entries when it stores its own: one file, both packages'
    entries (the reference's block sizes beside the port's launch
    shapes)."""
    ref_entry = ("decode", "cpu", (32, 6, 12, 8), (1024, 256),
                 {"block_words": 512, "block_windows": 128})
    port_entry = ("decode", "cuda:NVIDIA H100 80GB HBM3", (32, 6, 12, 8),
                  (1024, 256), {"idct_rw": 4})
    first, second = ((ref_autotune, ref_entry), (autotune, port_entry))
    if writer == "port":
        first, second = second, first
    mod, entry = first
    mod.TuningCache(str(tmp_path)).store(*entry)
    other_mod, other_entry = second
    other = other_mod.TuningCache(str(tmp_path))
    assert other.lookup(*entry[:4]) == entry[4]  # loaded
    other.store(*other_entry)  # re-saves the file with both entries
    for m in (ref_autotune, autotune):
        both = m.TuningCache(str(tmp_path))
        assert len(both) == 2
        assert both.lookup(*ref_entry[:4]) == ref_entry[4]
        assert both.lookup(*port_entry[:4]) == port_entry[4]


# ---------------------------------------------------------------------------
# The port's knobs: legal only where the launchers accept them.
# ---------------------------------------------------------------------------
def test_knob_legality_follows_the_launchers():
    # E = N = 128: lut_idct's buffers fit only at rw = 4
    assert tiles.idct_rws(128, 128) == (4,)
    assert blocks_legal("decode", (128, 128, 12, 8), {"idct_rw": 4})
    assert not blocks_legal("decode", (128, 128, 12, 8), {"idct_rw": 8})
    # the archive's widths take both
    assert blocks_legal("decode", DEC, {"idct_rw": 8})
    assert not blocks_legal("decode", DEC, {"idct_rw": 2})
    # a v3 tile only on a v3 plan key, and only where it fits 44 KiB
    v3 = DEC + (2, 2, 1)
    assert blocks_legal("decode", v3, {"idct_rw": 8, "v3_tile_windows": 1024})
    assert not blocks_legal("decode", DEC, {"idct_rw": 8,
                                            "v3_tile_windows": 1024})
    assert not blocks_legal("decode", v3, {"idct_rw": 8,
                                           "v3_tile_windows": 100})
    assert not blocks_legal("decode", (32, 32, 12, 8, 2, 2, 1),
                            {"idct_rw": 8, "v3_tile_windows": 2048})
    # levels_rw: rw = 4 needs the staging buffers to fit with every thread
    assert tiles.levels_rws(32, 6) == (2, 1)
    assert not blocks_legal("encode", ENC, {"levels_rw": 4})
    assert blocks_legal("encode", (32, 16, 64), {"levels_rw": 4})
    # a reference entry's keys are not the port's
    assert not blocks_legal("decode", DEC, {"block_words": 512})
    assert not blocks_legal("encode", ENC, {"block_rows": 2})


def test_tile_mirrors_match_the_layout_mirrors():
    """The port's host mirror of the launchers' tiles, with no rw forced,
    equals the tests' own mirrors of the kernels' pick at every width."""
    import _idct_layouts
    import _levels_layouts

    for e in (1, 3, 6, 8, 16, 32, 64, 100, 128):
        for n in (e, 32, 64, 128):
            if n < e:
                continue
            got = tiles.idct_tile_shape(e, n)
            want = _idct_layouts.tile_shape(e, n)
            assert (got.rw, got.bw, got.aw, got.smem) == (
                want["rw"], want["bw"], want["aw"], want["smem"])
            assert tiles.dct_tile_shape(n, e).bw == (
                _levels_layouts.block_windows(n, e))
    # a forced rw the pick would also make gives the pick's tile
    assert tiles.idct_tile_shape(6, 32, 8) == tiles.idct_tile_shape(6, 32)
    assert tiles.dct_tile_shape(32, 6, 2) == tiles.dct_tile_shape(32, 6)
    assert tiles.dct_tile_shape(32, 6, 3) is None


def test_illegal_entry_dropped_and_retuned(tmp_path, monkeypatch):
    """An entry naming a launch shape its launcher refuses (a persisted
    idct_rw = 8 at E = N = 128) is dropped at lookup — tuned_blocks reads
    {} and the file loses it — and tune() re-runs the sweep for it."""
    plan = (128, 128, 12, 8)
    cache = TuningCache(str(tmp_path))
    cache.store("decode", "cpu", plan, (64, 64), {"idct_rw": 8})
    set_default_cache(cache)
    try:
        assert tuned_blocks("decode", plan, (64, 64), backend="cpu") == {}
        assert cache.lookup("decode", "cpu", plan, (64, 64)) is None
        assert len(TuningCache(str(tmp_path))) == 0
    finally:
        set_default_cache(None)
    cache.store("decode", "cpu", plan, (64, 64), {"idct_rw": 8})
    calls = []
    got = tune(
        "decode", plan, (64, 64), calls.append,
        decode_block_candidates(128, 128), cache=cache, backend="cpu",
        trials=1, warmup=0,
        valid=lambda b: blocks_legal("decode", plan, b),
    )
    assert got == {"idct_rw": 4} and calls == [{"idct_rw": 4}]
    assert cache.lookup("decode", "cpu", plan, (64, 64)) == {"idct_rw": 4}


def test_block_memo_resolves_once_per_epoch(tmp_path, monkeypatch):
    """A kernel module's memo reads the cache once per (shape, epoch): a
    warm bucket does not touch the cache, a store re-resolves, and the
    CPU resolves nothing."""
    monkeypatch.setattr(autotune, "_device_info",
                        lambda index: ("Fake", tiles.H100_SMEM_OPTIN))
    cache = TuningCache(str(tmp_path))
    set_default_cache(cache)
    try:
        memo = BlockMemo(lambda *plan: plan)
        assert memo.get("decode", DEC, (64, 64), "cpu") == {}
        assert cache.hits == cache.misses == 0
        assert memo.get("decode", DEC, (64, 64), "cuda:0") == {}
        assert memo.get("decode", DEC, (64, 64), "cuda:0") == {}
        assert cache.misses == 1  # the second call was the memo's
        cache.store("decode", "cuda:Fake", DEC, (64, 64), {"idct_rw": 4})
        assert memo.get("decode", DEC, (64, 64), "cuda:0") == {"idct_rw": 4}
        assert memo.get("decode", DEC, (64, 64), "cuda:0") == {"idct_rw": 4}
        assert cache.hits == 1
    finally:
        set_default_cache(None)


@pytest.mark.parametrize("which", ["decode", "encode"])
def test_sweeps_refuse_the_cpu(which):
    """The plain versions have no launch shape: a sweep on the CPU raises
    instead of timing nothing."""
    from repro_torch.core import DOMAIN_DEFAULTS, calibrate
    from repro_torch.data import make_signal

    tab = calibrate(make_signal("load_power", 4096, seed=1),
                    DOMAIN_DEFAULTS["power"])
    with pytest.raises(ValueError, match="CUDA device"):
        if which == "decode":
            autotune.tune_decode_bucket(tab, num_words=64, num_windows=16,
                                        device="cpu")
        else:
            autotune.tune_encode_bucket(tab, rows=2, num_windows=16,
                                        device="cpu")


# ---------------------------------------------------------------------------
# tune(): the sweep contract.
# ---------------------------------------------------------------------------
def test_tune_hit_returns_without_running(tmp_path):
    cache = TuningCache(str(tmp_path))
    cache.store("decode", "cpu", DEC, (64, 64), {"idct_rw": 4})
    calls = []
    got = tune(
        "decode", DEC, (64, 64),
        runner=lambda blocks: calls.append(blocks),
        candidates=[{"idct_rw": 8}, {"idct_rw": 4}],
        cache=cache, backend="cpu",
    )
    assert got == {"idct_rw": 4}
    assert calls == []  # the hit path never executed a candidate


def test_tune_force_retunes_and_stores(tmp_path):
    cache = TuningCache(str(tmp_path))
    cache.store("decode", "cpu", DEC, (64, 64), {"idct_rw": 4})
    calls = []
    cands = [{"idct_rw": 8}, {"idct_rw": 4}]
    got = tune(
        "decode", DEC, (64, 64),
        runner=calls.append, candidates=cands,
        cache=cache, backend="cpu", force=True, trials=1, warmup=0,
    )
    assert got in cands
    assert calls  # the sweep actually ran
    assert cache.lookup("decode", "cpu", DEC, (64, 64)) == got


def test_tune_takes_the_runners_own_time(tmp_path):
    """A runner that times itself (the card's CUDA-event runners) decides
    the winner by its own seconds, and record() sees every candidate."""
    cache = TuningCache(str(tmp_path))
    seen = []
    times = {1: 3e-3, 2: 1e-3, 4: 2e-3}
    got = tune(
        "encode", (32, 16, 64), (8, 1024),
        runner=lambda b: times[b["levels_rw"]],
        candidates=encode_block_candidates(32, 16), cache=cache,
        backend="cpu", trials=2, warmup=1,
        record=lambda b, t: seen.append((b["levels_rw"], t)),
    )
    assert got == {"levels_rw": 2}
    assert sorted(seen) == [(1, 3e-3), (2, 1e-3), (4, 2e-3)]


def test_tune_rank_and_top_k_prune_the_sweep(tmp_path):
    cache = TuningCache(str(tmp_path))
    cands = [{"v3_tile_windows": w} for w in (256, 512, 1024, 2048)]
    calls = []
    got = tune(
        "decode", (33,), (64, 64),
        runner=calls.append, candidates=cands,
        cache=cache, backend="cpu", trials=1, warmup=0,
        rank=lambda b: -b["v3_tile_windows"],  # the model: biggest first
        top_k=1,
    )
    assert got == {"v3_tile_windows": 2048}
    assert calls == [{"v3_tile_windows": 2048}]  # pruned to the model's pick


def test_tune_requires_candidates(tmp_path):
    cache = TuningCache(str(tmp_path))
    with pytest.raises(ValueError, match="candidate"):
        tune("decode", (1,), (1,), lambda b: None, [], cache=cache,
             backend="cpu")


def test_tune_coalesces_concurrent_same_key_sweeps(tmp_path):
    """Eight threads tuning one key run one sweep (the leader's) and all
    return its winner — a store per racer would bump the epoch eight
    times and make every engine re-resolve."""
    cache = TuningCache(directory=str(tmp_path))
    sweeps = []
    gate = threading.Event()

    def runner(blocks):
        if not sweeps:
            gate.wait(5)
        sweeps.append(blocks)

    results = []

    def racer():
        results.append(tune(
            "kind", (0, 8, 8, 8), (128,), runner,
            [{"bm": 8}, {"bm": 16}], cache=cache, backend="cpu", trials=1,
            warmup=0,
        ))

    threads = [threading.Thread(target=racer) for _ in range(8)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    gate.set()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    # one sweep total (2 candidates x (warmup 0 + 1 trial) runs), not 8
    assert len(sweeps) == 2, f"{len(sweeps)} runs"
    assert len(results) == 8
    assert all(r == results[0] for r in results)


def test_tuned_blocks_consults_pinned_default_cache(tmp_path):
    cache = TuningCache(str(tmp_path))
    set_default_cache(cache)
    try:
        assert tuned_blocks("decode", DEC, (128, 64)) == {}
        cache.store("decode", "cpu", DEC, (128, 64), {"idct_rw": 4})
        assert tuned_blocks("decode", DEC, (128, 64)) == {"idct_rw": 4}
        assert tuned_blocks("decode", DEC, (128, 64), device="cpu") == {
            "idct_rw": 4}
    finally:
        set_default_cache(None)


def test_block_candidates_are_the_legal_shapes():
    """The sweep grids hold every shape the launchers accept and nothing
    else; a v3 grid crosses the register tiles with the v3 tiles."""
    assert decode_block_candidates(32, 6) == [{"idct_rw": 8}, {"idct_rw": 4}]
    assert decode_block_candidates(128, 128) == [{"idct_rw": 4}]
    v3 = decode_block_candidates(32, 32, (2, 2, True))
    assert v3 == [{"idct_rw": rw, "v3_tile_windows": t}
                  for rw in (8, 4) for t in (256, 512, 1024)]
    for c in v3:
        assert blocks_legal("decode", (32, 32, 12, 8, 2, 2, 1), c)
    assert encode_block_candidates(32, 6) == [{"levels_rw": 2},
                                              {"levels_rw": 1}]
    assert encode_block_candidates(64, 64) == [
        {"levels_rw": 4}, {"levels_rw": 2}, {"levels_rw": 1}]


# ---------------------------------------------------------------------------
# BucketPolicy ladders.
# ---------------------------------------------------------------------------
def test_policy_round_contracts():
    from repro_torch.serving.engine import p2

    for pol in (P2, HALF_OCTAVE, COST_BALANCED):
        prev = 0
        for x in (1, 2, 3, 5, 7, 12, 100, 1000, 4097):
            r = pol.round(x)
            assert r >= x  # never below the input
            assert pol.round(r) == r  # idempotent on edges
            assert r >= prev  # monotone
            prev = r
    for x in (1, 2, 3, 5, 100, 1000, 4097):
        assert P2.round(x) == p2(x)
    assert HALF_OCTAVE.round(5) == 6
    assert HALF_OCTAVE.round(100) == 128
    assert COST_BALANCED.round(5) == 5


def test_policy_variant_bound_is_density_times_octaves():
    hi = 1 << 16
    p2_variants = P2.max_variants(1, hi)
    assert p2_variants <= 17
    assert HALF_OCTAVE.max_variants(1, hi) <= 2 * p2_variants
    assert COST_BALANCED.max_variants(1, hi) <= (
        len(COST_BALANCED.multipliers) * p2_variants
    )


def test_policy_resolution_and_env(monkeypatch):
    assert BucketPolicy.of(P2) is P2
    assert BucketPolicy.of("half_octave") is HALF_OCTAVE  # normalized
    monkeypatch.setenv("FPTC_BUCKET_POLICY", "cost-balanced")
    assert BucketPolicy.of(None) is COST_BALANCED
    monkeypatch.delenv("FPTC_BUCKET_POLICY")
    assert BucketPolicy.of(None) is P2
    with pytest.raises(ValueError, match="unknown bucket policy"):
        BucketPolicy.of("bogus")


def test_policy_validates_multipliers():
    with pytest.raises(ValueError):
        BucketPolicy("empty", ())
    with pytest.raises(ValueError):
        BucketPolicy("bad", (2.0,))
    with pytest.raises(ValueError):
        BucketPolicy("bad", (0.5,))


def test_cost_balanced_ladder_from_model():
    pol = cost_balanced_policy()
    d = len(pol.multipliers)
    assert 1 <= d <= 4
    assert pol.multipliers[0] == 1.0
    assert all(
        pol.multipliers[i] < pol.multipliers[i + 1] for i in range(d - 1)
    )
    assert POLICY_NAMES == ("p2", "half-octave", "cost-balanced")
    assert POLICY_NAMES == ref_policy.POLICY_NAMES


@pytest.mark.parametrize("name", ["p2", "half-octave", "cost-balanced"])
def test_ladders_match_reference(name):
    """Each ladder has the reference's edges over 1..2**20 — here both run
    the ``cpu`` profile — and so rounds every size there as the reference
    does; rounding is checked exhaustively around every edge and on a
    random sample between them."""
    port, ref = BucketPolicy.of(name), ref_policy.BucketPolicy.of(name)
    assert port.multipliers == ref.multipliers
    hi = 1 << 20
    edges = port.edges(1, hi)
    assert edges == ref.edges(1, hi)
    xs = {1, hi}
    for e in edges:
        xs.update((e - 1, e, e + 1))
    xs.update(np.random.default_rng(5).integers(1, hi, size=4000).tolist())
    for x in sorted(x for x in xs if 1 <= x <= hi):
        assert port.round(x) == ref.round(x)
    if name == "cost-balanced":
        assert cost_balanced_policy(CostModel(backend="cpu")).multipliers == (
            ref_policy.cost_balanced_policy(
                ref_cost_model.CostModel(backend="cpu")).multipliers)


# ---------------------------------------------------------------------------
# Cost model.
# ---------------------------------------------------------------------------
def test_cost_model_monotone_in_shape():
    cm = CostModel(backend="cpu")
    base = cm.decode_bucket_cost(1024, 256, e=6, n=32)
    assert cm.decode_bucket_cost(2048, 256, e=6, n=32) > base
    assert cm.decode_bucket_cost(1024, 512, e=6, n=32) > base
    enc = cm.encode_bucket_cost(8, 128, e=6, n=32)
    assert cm.encode_bucket_cost(16, 128, e=6, n=32) > enc
    assert cm.signal_decode_cost(100, 50, e=6, n=32) > 0
    assert cm.signal_encode_cost(50, e=6, n=32) > 0


def test_cost_model_charges_launch_shapes():
    """The port's knobs cost what they cost the kernels: a window count
    just past a tile pays the next tile's padding, a v3 tile adds its
    stage, and a shape the launcher refuses is refused here too."""
    cm = CostModel(backend="cuda")
    bw = tiles.idct_tile_shape(6, 32).bw
    assert cm.decode_bucket_cost(64, bw + 1, e=6, n=32) > (
        cm.decode_bucket_cost(64, bw, e=6, n=32))
    assert cm.decode_bucket_cost(64, 4096, e=6, n=32, v3_tile_windows=256) > (
        cm.decode_bucket_cost(64, 4096, e=6, n=32))
    with pytest.raises(ValueError):
        cm.decode_bucket_cost(64, 64, e=128, n=128, idct_rw=8)
    with pytest.raises(ValueError):
        cm.decode_bucket_cost(64, 64, e=6, n=32, v3_tile_windows=300)
    with pytest.raises(ValueError):
        cm.encode_bucket_cost(8, 64, e=6, n=32, levels_rw=4)
    # the pick's rw is the 0 shape's cost
    assert cm.encode_bucket_cost(8, 1000, e=6, n=32, levels_rw=2) == (
        cm.encode_bucket_cost(8, 1000, e=6, n=32))


def test_cost_model_seed_rescales():
    cm = CostModel(backend="cpu")
    raw = cm.signal_decode_cost(100, 50, e=6, n=32)
    cm.seed(
        "decode",
        2.0 * cm.decode_flops(100, 50, e=6, n=32),
        cm.decode_bytes(100, 50, e=6, n=32),
        words=100, windows=50, e=6, n=32,
    )
    assert cm.signal_decode_cost(100, 50, e=6, n=32) == pytest.approx(
        2.0 * raw
    )


def test_cost_model_observe_calibrates():
    cm = CostModel(backend="cpu")
    t = cm.decode_bucket_cost(1024, 256, e=6, n=32)
    cm.observe("decode", predicted_s=1.0, measured_s=3.0)
    assert cm.calibration("decode") == pytest.approx(3.0)
    assert cm.decode_bucket_cost(1024, 256, e=6, n=32) == pytest.approx(
        3.0 * t
    )
    cm.observe("decode", predicted_s=0.0, measured_s=1.0)  # ignored
    assert cm.calibration("decode") == pytest.approx(3.0)


def test_edges_per_octave_bounded():
    for backend in ("cpu", "cuda", "tpu"):
        d = CostModel(backend=backend).edges_per_octave()
        assert 1 <= d <= 4
    assert default_cost_model() is default_cost_model()
    assert default_cost_model("cuda") is default_cost_model("cuda:0")


@pytest.mark.parametrize("shape", [(1024, 256, 6, 32, 8), (1, 1, 1, 1, 1),
                                   (65536, 8192, 32, 32, 24),
                                   (3000, 700, 16, 16, 64)])
def test_cpu_profile_matches_reference(shape):
    """The ``cpu`` profile's constants and analytic counts are the
    reference's: every count, per-signal cost and the edge density agree
    exactly on the same inputs, seeded or not."""
    words, windows, e, n, ms = shape
    port = CostModel(backend="cpu")
    ref = ref_cost_model.CostModel(backend="cpu")
    for cm in (port, ref):
        cm.seed("encode", 3.0e9, 1.0e8, rows=4, windows_per_row=64, e=8,
                n=32)
    assert port.profile.peak_flops == ref.profile.peak_flops
    assert port.profile.compile_cost_s == ref.profile.compile_cost_s
    assert port.decode_flops(words, windows, e=e, n=n, max_symlen=ms) == (
        ref.decode_flops(words, windows, e=e, n=n, max_symlen=ms))
    assert port.decode_bytes(words, windows, e=e, n=n) == (
        ref.decode_bytes(words, windows, e=e, n=n))
    assert port.encode_flops(words, windows, e=e, n=n) == (
        ref.encode_flops(words, windows, e=e, n=n))
    assert port.encode_bytes(words, windows, e=e, n=n) == (
        ref.encode_bytes(words, windows, e=e, n=n))
    assert port.signal_decode_cost(words, windows, e=e, n=n,
                                   max_symlen=ms) == (
        ref.signal_decode_cost(words, windows, e=e, n=n, max_symlen=ms))
    assert port.signal_encode_cost(windows, e=e, n=n) == (
        ref.signal_encode_cost(windows, e=e, n=n))
    assert port.edges_per_octave() == ref.edges_per_octave()
    assert port.edges_per_octave(ref_words=words, ref_dispatches=windows) == (
        ref.edges_per_octave(ref_words=words, ref_dispatches=windows))


def test_cuda_default_is_seeded_from_the_port_counts():
    """The card's default model reproduces the port's own kernel counts at
    its seed shape (not the reference's analytic or jaxpr counts)."""
    from repro_torch.tuning import cost_model

    cm = default_cost_model("cuda")
    assert cm.profile.peak_flops == 67e12 and cm.profile.hbm_bps == 3.35e12
    words, windows = cost_model._SEED_WORDS, cost_model._SEED_WINDOWS
    flops, nbytes = cost_model.port_decode_counts(words, windows, e=8, n=32)
    sf, sb = cm._scales("decode")
    assert sf * cm.decode_flops(words, windows, e=8, n=32) == pytest.approx(
        flops)
    assert sb * cm.decode_bytes(words, windows, e=8, n=32) == pytest.approx(
        nbytes)
    assert CostModel(backend="cuda")._scales("decode") == (1.0, 1.0)
