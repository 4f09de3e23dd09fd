"""The port's batched decode engine — the slice as a whole — held against the
JAX package.

The archive is encoded by the JAX package and crosses as bytes; tables
cross through ``tables_from_arrays``.  ``BatchDecoder(device="cpu")`` runs
every kernel wrapper's plain version.  Float bound, stated against the
reference's XLA engine arm ``repro.serving.BatchDecoder(use_kernels=False)``:
``max|d| <= 1e-5 * max|ref|`` per signal.  The same engine on the card:
``tests/test_torch_gpu.py``."""
import dataclasses

import pytest

jnp = pytest.importorskip("jax.numpy")  # the reference; absent on the card

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _synth import uniform_code_container
from repro.core import codec as ref_codec
from repro.core.calibration import calibrate as ref_calibrate
from repro.core.config import DOMAIN_DEFAULTS
from repro.data import make_signal
from repro.serving import BatchDecoder as RefBatchDecoder
from repro_torch.core import codec
from repro_torch.core.calibration import tables_from_arrays
from repro_torch.core.container import Container
from repro_torch.kernels import ops
from repro_torch.serving import BatchDecoder, streams_from_containers
from repro_torch.serving.engine import p2

REL_TOL = 1e-5
SIGNAL_LEN = 3001

ARCHIVAL = [
    ("biomedical", "mitbih"),
    ("seismic", "seismic"),
    ("power", "load_power"),
    ("meteorological", "temperature"),
]
CODINGS = [
    {},
    dict(predictor="delta", predict_bands=2, zero_planes=True),
    dict(predictor="linear2", predict_bands=2, zero_planes=True),
]


def carry(ref_tables):
    q = ref_tables.quant
    return tables_from_arrays(
        dataclasses.asdict(ref_tables.config), ref_tables.domain_id,
        zone=np.asarray(q.zone), scale=np.asarray(q.scale), mu=float(q.mu),
        alpha1=float(q.alpha1), lengths=np.asarray(ref_tables.book.lengths),
    )


def assert_close(got, ref, rel=REL_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max(initial=0.0) <= rel * max(
        np.abs(ref).max(initial=0.0), 1e-30
    )


@pytest.fixture(scope="module")
def archive():
    """The four archival domains x {v2, v3 delta, v3 linear2}, encoded by
    the JAX package: (blobs, reference tables, port tables).  Each domain is
    calibrated once; its v3 tables overlay the coding on the v2 tables (the
    same quant table and codebook, which Laplace smoothing makes cover every
    symbol), as the golden v3 tables do.  The strip and both signals have
    one length (a partial last window), so the reference compiles each
    domain's eager ops once."""
    ref_tables, blobs = {}, []
    for d, (dom, ds) in enumerate(ARCHIVAL):
        strip = make_signal(ds, SIGNAL_LEN, seed=d)
        sigs = [make_signal(ds, SIGNAL_LEN, seed=100 + 4 * d + i)
                for i in range(2)]
        v2 = ref_calibrate(strip, DOMAIN_DEFAULTS[dom], domain_id=d)
        for j, coding in enumerate(CODINGS):
            did = 4 * j + d
            t = dataclasses.replace(v2, config=v2.config.replace(**coding),
                                    domain_id=did)
            ref_tables[did] = t
            blobs += [ref_codec.encode(s, t).to_bytes() for s in sigs]
    # interleave the plan keys
    blobs = blobs[0::2] + blobs[1::2]
    port_tables = {k: carry(t) for k, t in ref_tables.items()}
    return blobs, ref_tables, port_tables


def _ref_containers(blobs):
    from repro.core.container import Container as RefContainer

    return [RefContainer.from_bytes(b) for b in blobs]


def test_mixed_archive_matches_reference_engine(archive):
    blobs, ref_tables, port_tables = archive
    ref = RefBatchDecoder(use_kernels=False, devices=None).decode(
        _ref_containers(blobs), ref_tables
    ).to_host()
    cs = [Container.from_bytes(b) for b in blobs]
    dec = BatchDecoder(device="cpu")
    before = dict(ops.LAUNCHES)
    out = dec.decode(cs, port_tables).to_host()
    assert ops.LAUNCHES == before  # the CPU runs the plain versions only
    assert len(out) == len(ref) == len(blobs)
    for got, want in zip(out, ref):
        assert_close(got, want)
    assert dec.stats.dispatches == len(ARCHIVAL) * len(CODINGS)
    # and against the host decode (the reference's and the port's)
    for c, got in zip(cs, out):
        assert_close(got, codec.decode(c, port_tables[c.domain_id]))


def test_v3_archive_decodes_like_v2(archive):
    """The v3 codings re-code the same levels: each v3 signal decodes to
    its v2 twin exactly (the v3 tables share the v2 quant table)."""
    blobs, _, port_tables = archive
    cs = [Container.from_bytes(b) for b in blobs]
    out = BatchDecoder(device="cpu").decode(cs, port_tables).to_host()
    by_key = {}
    half = len(cs) // 2  # the archive holds every first signal, then every second
    for i, (c, o) in enumerate(zip(cs, out)):
        by_key.setdefault((c.domain_id % 4, i < half), []).append(o)
    for outs in by_key.values():
        assert len(outs) == len(CODINGS)
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])


def test_streams_and_submit_flush_match_decode(archive):
    blobs, _, port_tables = archive
    cs = [Container.from_bytes(b) for b in blobs[:6]]
    ref = BatchDecoder(device="cpu").decode(cs, port_tables).to_host()
    groups, member_pos = streams_from_containers(cs)
    assert [g.plan_key for g in groups] == list(
        dict.fromkeys(c.plan_key for c in cs)
    )
    dec = BatchDecoder(device="cpu", pipeline=False)
    outs = dec.decode_streams(groups, port_tables).to_host()
    for i in range(len(cs)):
        np.testing.assert_array_equal(outs[member_pos[i]], ref[i])
    for i, c in enumerate(cs):
        assert dec.submit(c) == i
    assert dec.pending == len(cs)
    flushed = dec.flush(port_tables).to_host()
    assert dec.pending == 0
    for a, b in zip(flushed, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_words", [255, 256, 257])
def test_bucket_boundary_word_counts(num_words):
    """Exactly at / one over a power-of-two word count: padding words
    contribute no symbols."""
    ref_c, ref_tables = uniform_code_container(num_words, seed=num_words)
    c = Container.from_bytes(ref_c.to_bytes())
    tables = carry(ref_tables)
    out = BatchDecoder(device="cpu").decode([c], tables).to_host()[0]
    ref = RefBatchDecoder(use_kernels=False, devices=None).decode(
        [ref_c], ref_tables
    ).to_host()[0]
    assert_close(out, ref)
    assert_close(out, ref_codec.decode(ref_c, ref_tables))


def test_bucket_boundary_batch_mix():
    c1, ref_tables = uniform_code_container(256, seed=1)
    c2, _ = uniform_code_container(257, seed=2)
    tables = carry(ref_tables)
    cs = [Container.from_bytes(c.to_bytes()) for c in (c1, c2)]
    dec = BatchDecoder(device="cpu")
    outs = dec.decode(cs, tables).to_host()
    assert dec.stats.bucket_pad[-1]["words_padded"] == p2(513)
    for o, c in zip(outs, (c1, c2)):
        assert_close(o, ref_codec.decode(c, ref_tables))


def test_empty_batch():
    dec = BatchDecoder(device="cpu")
    batch = dec.decode([], {})
    assert len(batch) == 0 and batch.to_host() == []
    assert dec.flush({}).to_host() == []


def test_mismatched_tables_raise(archive):
    blobs, _, port_tables = archive
    c = Container.from_bytes(blobs[0])
    wrong = port_tables[(c.domain_id + 1) % 4]
    dec = BatchDecoder(device="cpu")
    with pytest.raises(ValueError, match="plan_key"):
        dec.decode([c], wrong)
    with pytest.raises(KeyError, match="domain_id"):
        dec.decode([c], {99: wrong})
    other = Container.from_bytes(blobs[1])
    assert other.domain_id != c.domain_id
    with pytest.raises(ValueError, match="mixed-domain"):
        dec.decode([c, other], port_tables[c.domain_id])


def test_plan_cache_reuse_and_drain_once(archive):
    blobs, _, port_tables = archive
    c = Container.from_bytes(blobs[0])
    dec = BatchDecoder(device="cpu")
    first = dec.decode([c], port_tables)
    np.testing.assert_array_equal(
        first.device_signal(0).numpy(),
        codec.decode(c, port_tables[c.domain_id]),
    )
    assert len(first.device_windows) == 1
    a = first.to_host()[0]
    with pytest.raises(RuntimeError, match="once"):
        first.to_host()
    b = dec.decode([c], port_tables).to_host()[0]
    np.testing.assert_array_equal(a, b)
    assert dec.stats.plan_misses == 1
    assert dec.stats.plan_hits >= 1
    assert dec.plan_for(c, port_tables) is dec.plan_for(c, port_tables)


def test_decode_fixed_matches_reference():
    """The fixed-rate KV decode: the port's K3 (inline dequant, here its
    plain version) against the reference engine's ``decode_fixed`` (LUT
    dequant), within the float bound."""
    cfg = DOMAIN_DEFAULTS["kv"]
    rng = np.random.default_rng(0)
    strip = np.cumsum(rng.standard_normal(8192)).astype(np.float32) * 0.1
    ref_tables = ref_calibrate(strip, cfg, domain_id=8)
    levels = rng.integers(0, 256, (3, 4, 10, cfg.e)).astype(np.uint8)
    ref = np.asarray(RefBatchDecoder(use_kernels=False, devices=None)
                     .decode_fixed(jnp.asarray(levels), ref_tables,
                                   length=150))
    dec = BatchDecoder(device="cpu")
    got = dec.decode_fixed(torch.from_numpy(levels), carry(ref_tables),
                           length=150)
    assert got.shape == (3, 4, 150) and got.device.type == "cpu"
    assert_close(got.numpy(), ref)
    with pytest.raises(ValueError, match="E="):
        dec.decode_fixed(torch.from_numpy(levels[..., :4]),
                         carry(ref_tables))


def test_no_device_means_the_card():
    """BatchDecoder() with no device runs on the card — and raises where
    there is none, rather than quietly running on the CPU."""
    if torch.cuda.is_available():
        assert BatchDecoder().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            BatchDecoder()
        with pytest.raises(RuntimeError, match="CUDA"):
            BatchDecoder(device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        BatchDecoder(device="meta")


def test_bucket_helpers_and_policies_match_reference():
    from repro.serving import engine as ref_engine
    from repro.tuning import policy as ref_policy
    from repro_torch.serving import engine
    from repro_torch.tuning import policy

    for x in list(range(1, 600)) + [4095, 4096, 4097, 1 << 20]:
        assert engine.p2(x) == ref_engine.p2(x)
        assert engine.symlen_bucket(x) == ref_engine.symlen_bucket(x)
        for name in ("p2", "half-octave", "cost-balanced"):
            assert (policy.BucketPolicy.of(name).round(x)
                    == ref_policy.BucketPolicy.of(name).round(x))
    with pytest.raises(ValueError, match="unknown"):
        policy.BucketPolicy.of("p3")


def test_plan_cache_single_flight_under_contention():
    """Many threads missing on one key build its plan once and share it
    (the staging worker and the dispatching thread both fetch plans)."""
    import sys
    import threading
    import time

    from repro_torch.serving._plans import PlanCache

    builds = []

    def factory(tables, key, device):
        builds.append(key)
        time.sleep(0.005)  # hold the build open so racers coalesce
        return object()

    cache = PlanCache(factory, maxsize=16)
    tables = object()
    got, errors = [], []

    def worker():
        try:
            for k in range(8):
                got.append((k, cache.get(tables, ("k", k))))
        except Exception as exc:  # surfaced below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert len(got) == 16 * 8
    assert sorted(builds) == [("k", k) for k in range(8)]  # one build each
    plans = {}
    for k, plan in got:
        assert plans.setdefault(k, plan) is plan  # every thread shares it
    assert cache.misses == 8


def test_decode_to_host_block_until_ready_and_stats_match_reference(
        archive):
    """``decode_to_host``, ``DecodedBatch.block_until_ready`` and the
    ``batches`` / ``containers`` counters (of the decoder) and ``runs`` /
    ``buckets`` / ``pipelined_buckets`` / ``max_inflight`` (of its
    executor) against the reference engine's after the same calls."""
    blobs, ref_tables, port_tables = archive
    ref_dec = RefBatchDecoder(use_kernels=False, devices=None)
    dec = BatchDecoder(device="cpu")
    ref = ref_dec.decode_to_host(_ref_containers(blobs), ref_tables)
    got = dec.decode_to_host([Container.from_bytes(b) for b in blobs],
                             port_tables)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert_close(g, r)
    # one container (one bucket: the serial path), then none
    ref_b = ref_dec.decode(_ref_containers(blobs[:1]), ref_tables)
    b = dec.decode([Container.from_bytes(blobs[0])], port_tables)
    assert ref_b.block_until_ready() is ref_b
    assert b.block_until_ready() is b
    assert_close(b.to_host()[0], ref_b.to_host()[0])
    ref_dec.decode([], ref_tables)
    dec.decode([], port_tables)
    for name in ("batches", "containers"):
        assert getattr(dec.stats, name) == getattr(ref_dec.stats, name)
    for name in ("runs", "buckets", "pipelined_buckets", "max_inflight"):
        assert (getattr(dec.executor.stats, name)
                == getattr(ref_dec.executor.stats, name)), name
    assert dec.stats.batches == 3 and dec.executor.inflight == 0
    dec.close()


@pytest.mark.parametrize("pipeline,n,fail_at", [
    (False, 3, None), (True, 1, None), (True, 2, None), (True, 5, None),
    (False, 4, 2), (True, 4, 2)])
def test_executor_inflight_and_stats_match_reference(pipeline, n, fail_at):
    """The executor's in-flight gauge, read inside each dispatch, and its
    counters after the run (and after an upload that raises) equal the
    reference executor's on the same work."""
    from repro.serving.engine import PipelineExecutor as RefExecutor
    from repro_torch.serving.engine import PipelineExecutor

    ref = RefExecutor(pipeline=pipeline, prefetch=2)
    port = PipelineExecutor("cpu", pipeline=pipeline, prefetch=2)
    gauges = {}
    for ex in (ref, port):
        seen = gauges.setdefault(id(ex), [])

        def upload(b):
            if b == fail_at:
                raise RuntimeError("stage boom")
            return b + 1

        def dispatch(b, staged, ex=ex, seen=seen):
            seen.append(ex.inflight)
            return 2 * staged

        if fail_at is None:
            assert ex.run(list(range(n)), upload, dispatch) == [
                2 * (i + 1) for i in range(n)]
        else:
            with pytest.raises(RuntimeError, match="stage boom"):
                ex.run(list(range(n)), upload, dispatch)
        assert ex.run([], upload, dispatch) == []
        assert ex.inflight == 0
    assert gauges[id(port)] == gauges[id(ref)]
    for name in ("runs", "buckets", "pipelined_buckets", "max_inflight"):
        assert getattr(port.stats, name) == getattr(ref.stats, name), name
    port.close()


def test_executor_inflight_gauge_under_contention():
    """Threads running the executor at once (more than the cores) leave
    the in-flight gauge at 0 and its peak within the threads' count: an
    unlocked read-modify-write would lose updates here."""
    import os
    import sys
    import threading

    from repro_torch.serving.engine import PipelineExecutor

    ex = PipelineExecutor("cpu", pipeline=False)
    workers = 2 * (os.cpu_count() or 4)
    errors = []

    def worker():
        try:
            for _ in range(50):
                ex.run(list(range(4)), lambda b: b, lambda b, s: s)
        except Exception as exc:  # surfaced below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert ex.inflight == 0
    assert 1 <= ex.stats.max_inflight <= workers


def test_policy_edges_match_reference():
    """``BucketPolicy.edges`` / ``.max_variants`` against the reference's
    for both ladders the port has."""
    from repro.tuning import policy as ref_policy
    from repro_torch.tuning import policy

    for name in ("p2", "half-octave"):
        got, ref = policy.BucketPolicy.of(name), ref_policy.BucketPolicy.of(
            name)
        for lo, hi in ((1, 1), (0, 0), (1, 4096), (3, 3000), (1000, 1 << 20),
                       (4097, 4097), (5, 2)):
            assert got.edges(lo, hi) == ref.edges(lo, hi)
            assert got.max_variants(lo, hi) == ref.max_variants(lo, hi)
