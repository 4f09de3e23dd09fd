"""The port's serving frontend held against its own offline engines and
against the JAX package: the twins of ``tests/test_frontend.py``.

The contract: the frontend changes *when* requests dispatch (policy-edge
fill vs deadline slack), *whether* they are admitted (bounded queues shed
with typed errors, never silently), and *nothing else* — every admitted
request's response is byte-identical to the port's offline engines on the
same input, for decode, encode and transcode alike, in any interleaving.
Against the reference's offline engines (``use_kernels=False``, its XLA
arm): decoded samples within ``1e-5 * max|ref|``, encoded containers
byte-equal, transcoded containers by the flip rule of
``tests/test_torch_transcode.py``.  Tables are calibrated by the JAX
package and cross through ``tables_from_arrays``.  Every engine runs on
``device="cpu"``.

Left out of the reference's file: ``tune()``'s coalescing test (the
tuning cache is not ported yet) and the sharded parametrization (the port
serves from one device).  The frontend on the card:
``tests/test_torch_gpu.py`` and ``chip_smoke.py``'s serve phase.
"""
import threading
import time

import pytest

pytest.importorskip("jax")  # the reference; absent on the card

import numpy as np  # noqa: E402

from repro.core import DOMAIN_DEFAULTS  # noqa: E402
from repro.core import calibrate as ref_calibrate  # noqa: E402
from repro.data import make_signal  # noqa: E402
from repro.serving import BatchDecoder as RefBatchDecoder  # noqa: E402
from repro.serving import BatchEncoder as RefBatchEncoder  # noqa: E402
from repro.serving import Transcoder as RefTranscoder  # noqa: E402
from repro_torch.core.container import Container  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    BatchDecoder,
    BatchEncoder,
    DeadlineExpiredError,
    FrontendClosedError,
    FrontendConfig,
    QueueFullError,
    ServingFrontend,
    TrafficConfig,
    Transcoder,
    generate,
    policy_fill_target,
    replay,
)
from repro_torch.serving._plans import PlanCache  # noqa: E402
from repro_torch.tuning.policy import BucketPolicy  # noqa: E402
from test_torch_transcode import assert_matches_reference, carry  # noqa: E402

CPU = "cpu"
REL_TOL = 1e-5


@pytest.fixture(scope="module")
def ref_tables():
    power = ref_calibrate(make_signal("load_power", 65536, seed=7),
                          DOMAIN_DEFAULTS["power"], domain_id=0)
    meteo = ref_calibrate(make_signal("temperature", 65536, seed=8),
                          DOMAIN_DEFAULTS["meteorological"], domain_id=1)
    return {0: power, 1: meteo}


@pytest.fixture(scope="module")
def tables(ref_tables):
    return {d: carry(t) for d, t in ref_tables.items()}


def _frontend(tables, **cfg):
    return ServingFrontend(tables, device=CPU, config=FrontendConfig(**cfg))


@pytest.fixture(scope="module")
def offline(tables):
    """The port's offline engines and their results: the byte-identity
    baseline."""
    enc = BatchEncoder(pipeline=False, device=CPU)
    dec = BatchDecoder(pipeline=False, device=CPU)
    tr = Transcoder(decoder=dec, encoder=enc)
    n0 = tables[0].config.n
    signals = [make_signal("load_power", nw * n0, seed=40 + i)
               for i, nw in enumerate([2, 5, 3, 8, 1, 4])]
    containers = enc.encode_to_host(signals, tables[0])
    return {
        "signals": signals, "containers": containers,
        "decoded": dec.decode_to_host(containers, tables[0]),
        "transcoded": tr.transcode_to_host(containers, tables[0], tables[1]),
    }


# ---------------------------------------------------------------------------
# Admission edges: typed rejections, never silent drops.
# ---------------------------------------------------------------------------
def test_expired_deadline_rejected_at_admission(tables, offline):
    with _frontend(tables) as fe:
        with pytest.raises(DeadlineExpiredError):
            fe.submit_decode(offline["containers"][0], deadline_ms=0.0)
        with pytest.raises(DeadlineExpiredError):
            fe.submit_decode(offline["containers"][0], deadline_ms=-5.0)
        st = fe.stats_snapshot()
        assert st.rejected_expired == 2
        assert st.admitted == 0 and not fe.queue_depths()


def test_load_shed_error_surfaces_queue_depth(tables, offline):
    with _frontend(tables, max_batch=8, max_queue_depth=2,
                   default_slo_ms=60_000.0) as fe:
        futs = [fe.submit_decode(c) for c in offline["containers"][:2]]
        with pytest.raises(QueueFullError) as exc:
            fe.submit_decode(offline["containers"][2])
        assert exc.value.depth == 2
        assert exc.value.bound == 2
        assert exc.value.queue == ("decode",
                                   offline["containers"][2].plan_key)
        assert "2 pending" in str(exc.value)
        assert fe.stats_snapshot().shed == 1
        fe.flush()
        for f, ref in zip(futs, offline["decoded"][:2]):
            assert f.result(timeout=60).tobytes() == ref.tobytes()


def test_closed_frontend_rejects_and_nodrain_fails_pending(tables, offline):
    fe = _frontend(tables, default_slo_ms=60_000.0)
    fut = fe.submit_decode(offline["containers"][0])
    fe.close(drain=False)
    with pytest.raises(FrontendClosedError):
        fut.result(timeout=60)
    with pytest.raises(FrontendClosedError):
        fe.submit_decode(offline["containers"][0])
    fe.close()  # idempotent


# ---------------------------------------------------------------------------
# Dispatch triggers.
# ---------------------------------------------------------------------------
def test_single_request_flushes_on_deadline(tables, offline):
    with _frontend(tables, max_batch=16, default_slo_ms=150.0,
                   flush_slack_ms=120.0) as fe:
        out = fe.submit_decode(offline["containers"][0]).result(timeout=60)
        st = fe.stats_snapshot()
    assert out.tobytes() == offline["decoded"][0].tobytes()
    assert st.deadline_dispatches == 1 and st.batches == 1
    assert st.batch_size_sum == 1


def test_fill_dispatch_at_policy_edge(tables, offline):
    with _frontend(tables, max_batch=4, default_slo_ms=60_000.0) as fe:
        assert fe.fill_target == 4  # p2 edge at max_batch
        futs = [fe.submit_decode(c) for c in offline["containers"][:4]]
        outs = [f.result(timeout=60) for f in futs]
        st = fe.stats_snapshot()
    for out, ref in zip(outs, offline["decoded"][:4]):
        assert out.tobytes() == ref.tobytes()
    assert st.fill_dispatches >= 1
    assert st.deadline_dispatches == 0


def test_flush_and_drain_of_empty_queue_are_noops(tables):
    with _frontend(tables) as fe:
        fe.flush()
        fe.flush()
        time.sleep(0.05)
        st = fe.stats_snapshot()
        assert st.batches == 0 and st.admitted == 0
    st = fe.stats_snapshot()
    assert st.batches == 0 and st.completed == 0


def test_policy_fill_target_snaps_to_edges():
    p2 = BucketPolicy.of("p2")
    assert policy_fill_target(p2, 64) == 64
    assert policy_fill_target(p2, 48) == 32  # down, never up
    assert policy_fill_target(p2, 1) == 1


def test_no_device_means_the_card(tables, monkeypatch):
    """With no device the frontend's engines run on the card, and without
    one it raises: no quiet CPU fallback."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingFrontend(tables)


# ---------------------------------------------------------------------------
# Byte identity: micro-batching never changes bytes.
# ---------------------------------------------------------------------------
def test_mixed_interleaving_byte_identity(tables, offline):
    """Decode/encode/transcode interleaved through one frontend, fill and
    deadline dispatches mixed: every response byte-identical to the port's
    offline engines."""
    with _frontend(tables, max_batch=4, default_slo_ms=2_000.0) as fe:
        futs = []
        for i, c in enumerate(offline["containers"]):
            futs.append(("decode", i, fe.submit_decode(c)))
            futs.append(("encode", i,
                         fe.submit_encode(offline["signals"][i], 0)))
            futs.append(("transcode", i, fe.submit_transcode(c, 1)))
        fe.flush()
        results = [(k, i, f.result(timeout=120)) for k, i, f in futs]
        st = fe.stats_snapshot()
    assert st.completed == len(results) and st.failed == 0
    for kind, i, got in results:
        if kind == "decode":
            assert got.tobytes() == offline["decoded"][i].tobytes()
        elif kind == "encode":
            assert got.to_bytes() == offline["containers"][i].to_bytes()
        else:
            assert got.to_bytes() == offline["transcoded"][i].to_bytes()


def test_open_loop_replay_byte_identity(tables):
    cfg = TrafficConfig(rate=200.0, duration_s=0.3, seed=3, fixed_windows=4,
                        domains=(0, 1),
                        mix={"decode": 0.5, "encode": 0.3, "transcode": 0.2})
    reqs = generate(cfg, tables, device=CPU)
    assert reqs, "stream came out empty"
    with _frontend(tables, default_slo_ms=5_000.0) as fe:
        report = replay(fe, reqs)
        st = fe.stats_snapshot()
    assert report.completed == report.submitted == len(reqs)
    assert report.shed == 0 and report.failed == 0
    assert st.completed == st.admitted == len(reqs)


def test_responses_match_the_reference_engines(ref_tables, tables, offline):
    """The frontend's responses against the reference's offline engines
    (its XLA arm) on the same inputs: decode within ``1e-5 * max|ref|``,
    encode byte for byte, transcode by the flip rule."""
    ref_enc = RefBatchEncoder(use_kernels=False, devices=None, pipeline=False)
    ref_dec = RefBatchDecoder(use_kernels=False, devices=None, pipeline=False)
    ref_tr = RefTranscoder(decoder=ref_dec, encoder=ref_enc)
    sigs = offline["signals"]
    ref_cs = ref_enc.encode(sigs, ref_tables[0]).to_host()
    blobs = [c.to_bytes() for c in ref_cs]
    ref_dec_out = ref_dec.decode(ref_cs, ref_tables[0]).to_host()
    ref_tr_out = ref_tr.transcode(ref_cs, ref_tables[0], ref_tables[1],
                                  dst_domain_ids=[1] * len(ref_cs)).to_host()
    with _frontend(tables, max_batch=4, default_slo_ms=2_000.0) as fe:
        enc = [fe.submit_encode(s, 0) for s in sigs]
        dec = [fe.submit_decode(b) for b in blobs]  # raw wire bytes
        tr = [fe.submit_transcode(b, 1) for b in blobs]
        fe.flush()
        enc = [f.result(timeout=120) for f in enc]
        dec = [f.result(timeout=120) for f in dec]
        tr = [f.result(timeout=120) for f in tr]
    assert [c.to_bytes() for c in enc] == blobs
    for got, want in zip(dec, ref_dec_out):
        want = np.asarray(want)
        assert got.dtype == np.float32 and got.shape == want.shape
        bound = REL_TOL * max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= bound
    assert_matches_reference(
        tr, [Container.from_bytes(c.to_bytes()) for c in ref_tr_out],
        tables[1])


# ---------------------------------------------------------------------------
# The plan cache under concurrent submitters.
# ---------------------------------------------------------------------------
def test_plan_cache_single_flight_under_contention():
    builds = []
    gate = threading.Event()

    def factory(tables, key, device):
        builds.append(key)
        gate.wait(5)  # hold every racer at the build point
        return ("plan", key)

    cache = PlanCache(factory)
    tab = object()
    results = [None] * 16
    errs = []

    def racer(i):
        try:
            results[i] = cache.get(tab, "k", None)
        except BaseException as e:  # pragma: no cover - fails the assert
            errs.append(e)

    threads = [threading.Thread(target=racer, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    gate.set()
    for t in threads:
        t.join(10)
    assert not errs
    assert len(builds) == 1, "same-key warm raced to duplicate builds"
    assert all(r == ("plan", "k") for r in results)
    assert cache.misses == 1
    assert cache.coalesced + cache.hits == 15
    assert cache.coalesced >= 1


def test_plan_cache_failed_build_lets_waiters_retry():
    calls = []

    def factory(tables, key, device):
        calls.append(key)
        if len(calls) == 1:
            raise RuntimeError("leader loses")
        return "plan"

    cache = PlanCache(factory)
    tab = object()
    outcomes = []

    def racer():
        try:
            outcomes.append(cache.get(tab, "k", None))
        except RuntimeError:
            outcomes.append("raised")

    threads = [threading.Thread(target=racer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert outcomes.count("raised") == 1
    assert outcomes.count("plan") == 3
    assert len(cache._building) == 0
