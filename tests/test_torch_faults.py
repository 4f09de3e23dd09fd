"""The port's fault taxonomy as a contract, with no JAX in the process: the
twins of ``tests/test_faults.py`` on ``repro_torch.testing.faults``.

Frozen corrupt blobs (``tests/golden/corrupt/``) are reproduced byte for
byte by the port's ``corrupt`` and surface as their pinned
``EXPECTED_FAULT`` class; quarantine isolates poison per request with
byte-identical batch-mates; the retry policy absorbs transient faults (and
never re-runs poison); the watchdog cuts hung dispatches loose; ``health()``
reports it.  Every engine runs on ``device="cpu"`` (the plain versions), so
this file runs wherever the port does, the card's machine included.  The
reference's own parity for these blobs is ``tests/test_torch_quarantine.py``.
"""
import os
import threading

import numpy as np
import pytest

from repro_torch.core import DOMAIN_DEFAULTS, calibrate
from repro_torch.core.calibration import DomainTables
from repro_torch.core.config import CodecConfig
from repro_torch.core.container import Container, ContainerFormatError
from repro_torch.core.huffman import build_codebook
from repro_torch.core.quantize import build_quant_table
from repro_torch.data import make_signal
from repro_torch.kernels import ops
from repro_torch.serving import (
    BatchDecoder,
    BatchEncoder,
    DispatchFailedError,
    FrontendConfig,
    PoisonedContainerError,
    RetryPolicy,
    ServingFrontend,
    Transcoder,
    validate_or_poison,
)
from repro_torch.testing.faults import (
    CONTAINER_FAULTS,
    EXPECTED_FAULT,
    DispatcherFaultInjector,
    InjectedDispatchError,
    corrupt,
)

CORRUPT_DIR = os.path.join(os.path.dirname(__file__), "golden", "corrupt")
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
PINNED_SEED = 13  # the frozen blobs' seed (tests/golden/corrupt/regen.py)
CPU = "cpu"


def _frozen(fault: str) -> bytes:
    with open(os.path.join(CORRUPT_DIR, f"{fault}.fptc"), "rb") as f:
        return f.read()


def _golden(name: str) -> bytes:
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        return f.read()


def _golden_power_tables(v3: bool) -> DomainTables:
    """The golden power tables (``tests/_synth.py``'s ``golden_tables
    ("power", 2, v3)``) built with the port's builders from the same seeded
    draws: the config, domain id and code the blobs were cut with."""
    cfg = DOMAIN_DEFAULTS["power"]
    if v3:
        cfg = cfg.replace(predictor="delta", predict_bands=2,
                          zero_planes=True)
    rng = np.random.default_rng(1000 + 2)
    calib = rng.standard_normal((256, cfg.e)) * np.linspace(4.0, 0.5, cfg.e)
    quant = build_quant_table(
        calib, b1=cfg.b1, b2=cfg.b2, mu=cfg.mu, alpha1=cfg.alpha1,
        percentile=cfg.a0_percentile, scale_headroom=cfg.scale_headroom,
    )
    hist = rng.integers(1, 1000, 256).astype(np.int64)
    return DomainTables(config=cfg, quant=quant,
                        book=build_codebook(hist, l_max=cfg.l_max),
                        domain_id=2)


@pytest.fixture(scope="module")
def golden_tables():
    return {v3: _golden_power_tables(v3) for v3 in (False, True)}


@pytest.fixture(scope="module")
def serving_tables():
    sig = make_signal("load_power", 65536, seed=7)
    return calibrate(sig, DOMAIN_DEFAULTS["power"], domain_id=0)


def _tables_for_fault(fault, golden):
    return golden[fault == "reserved-flags"]


# ---------------------------------------------------------------------------
# The frozen corrupt-blob suite.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fault", CONTAINER_FAULTS)
def test_frozen_blob_bytes_are_pinned(fault):
    """The port's corrupt() regenerates each frozen blob from its golden
    source and pinned seed byte for byte."""
    src = "power_v3.fptc" if fault == "reserved-flags" else "power_v2.fptc"
    assert corrupt(_golden(src), fault, seed=PINNED_SEED) == _frozen(fault)


@pytest.mark.parametrize("fault", CONTAINER_FAULTS)
def test_frozen_blob_validates_to_expected_fault(fault, golden_tables):
    tables = _tables_for_fault(fault, golden_tables)
    container, err = validate_or_poison(_frozen(fault), 5, tables)
    assert container is None
    assert isinstance(err, PoisonedContainerError)
    assert err.fault in EXPECTED_FAULT[fault], f"{fault}: [{err.fault}] {err}"
    assert err.index == 5


@pytest.mark.parametrize("fault", CONTAINER_FAULTS)
def test_frozen_blob_poisons_engine_decode(fault, golden_tables):
    tables = _tables_for_fault(fault, golden_tables)
    dec = BatchDecoder(pipeline=False, device=CPU)
    out = dec.decode([_frozen(fault)], tables, quarantine=True).to_host()
    assert isinstance(out[0], PoisonedContainerError)
    assert out[0].fault in EXPECTED_FAULT[fault]


def test_golden_sources_decode_clean(golden_tables):
    """The blobs the frozen faults were cut from validate clean under the
    same tables: every fault above is the corruption's, not the tables'."""
    for v3, name in ((False, "power_v2.fptc"), (True, "power_v3.fptc")):
        c, err = validate_or_poison(_golden(name), 0, golden_tables[v3])
        assert err is None and isinstance(c, Container)


def test_wire_faults_raise_typed_without_quarantine():
    with pytest.raises(ContainerFormatError) as exc:
        Container.from_bytes(_frozen("flip-crc"), index=3)
    assert exc.value.fault == "crc-mismatch"
    assert exc.value.offset == 40
    assert exc.value.index == 3
    assert isinstance(exc.value, ValueError)
    with pytest.raises(ContainerFormatError) as exc:
        Container.from_bytes(_frozen("truncate"))
    assert exc.value.fault == "truncated"


def test_peek_parses_header_without_crc():
    golden = _golden("power_v2.fptc")
    hdr = Container.peek(golden)
    ref = Container.from_bytes(golden)
    assert hdr.plan_key == ref.plan_key
    assert hdr.domain_id == ref.domain_id
    assert Container.peek(
        corrupt(golden, "flip-words", seed=1)
    ).plan_key == ref.plan_key
    with pytest.raises(ContainerFormatError):
        Container.peek(corrupt(golden, "bad-magic", seed=1))


def test_corrupt_rejects_what_it_cannot_aim():
    with pytest.raises(ValueError, match="unknown fault"):
        corrupt(_golden("power_v2.fptc"), "no-such-fault")
    with pytest.raises(ValueError, match="needs a v3 container"):
        corrupt(_golden("power_v2.fptc"), "reserved-flags")


# ---------------------------------------------------------------------------
# Quarantine semantics: per-request poison, byte-identical batch-mates.
# ---------------------------------------------------------------------------
def test_quarantine_excludes_poison_and_keeps_batch_byte_identical(
    serving_tables,
):
    rng = np.random.default_rng(0)
    sigs = [rng.standard_normal(500).astype(np.float32) for _ in range(5)]
    enc = BatchEncoder(pipeline=False, device=CPU)
    blobs = [c.to_bytes() for c in enc.encode(sigs, serving_tables).to_host()]
    dec = BatchDecoder(pipeline=False, device=CPU)
    ref = dec.decode(
        [Container.from_bytes(b) for b in blobs], serving_tables
    ).to_host()
    items = list(blobs)
    items[1] = corrupt(blobs[1], "flip-words", seed=2)
    items[3] = corrupt(blobs[3], "truncate", seed=2)
    out = dec.decode(items, serving_tables, quarantine=True).to_host()
    assert isinstance(out[1], PoisonedContainerError)
    assert isinstance(out[3], PoisonedContainerError)
    assert out[1].index == 1 and out[3].index == 3
    for i in (0, 2, 4):
        np.testing.assert_array_equal(out[i], ref[i])
    assert dec.stats.quarantined == 2


def test_quarantine_transcode_excludes_poison_byte_identical(serving_tables):
    rng = np.random.default_rng(1)
    sigs = [rng.standard_normal(400).astype(np.float32) for _ in range(3)]
    dst = calibrate(make_signal("temperature", 65536, seed=8),
                    DOMAIN_DEFAULTS["meteorological"], domain_id=1)
    tabs = {0: serving_tables, 1: dst}
    enc = BatchEncoder(pipeline=False, device=CPU)
    blobs = [c.to_bytes() for c in enc.encode(
        sigs, tabs, domain_ids=[0, 0, 0]).to_host()]
    tr = Transcoder(pipeline=False, device=CPU)
    ref = [c.to_bytes() for c in tr.transcode(
        [Container.from_bytes(b) for b in blobs], tabs, tabs,
        dst_domain_ids=[1, 1, 1]).to_host()]
    items = [blobs[0], corrupt(blobs[1], "flip-sidecar", seed=3), blobs[2]]
    out = tr.transcode(items, tabs, tabs, dst_domain_ids=[1, 1, 1],
                       quarantine=True).to_host()
    assert isinstance(out[1], PoisonedContainerError)
    assert out[0].to_bytes() == ref[0]
    assert out[2].to_bytes() == ref[2]


def test_quarantine_demotes_histogram_gap_per_signal():
    """Tables whose code covers only the zero bin: the device-side gap flag
    is batch-fatal offline and a per-signal typed outcome under
    quarantine, the clean co-batched signal identical to encoding it
    alone."""
    hist = np.zeros(256, dtype=np.int64)
    hist[128] = 100
    rng = np.random.default_rng(0)
    quant = build_quant_table(rng.standard_normal((64, 8)), b1=2, b2=8,
                              mu=50.0, alpha1=0.004, percentile=99.9)
    tables = DomainTables(config=CodecConfig(n=8, e=8, b1=2, b2=8, l_max=8),
                          quant=quant, book=build_codebook(hist, l_max=8))
    gap_sig = np.sin(np.linspace(0, 30, 512)).astype(np.float32) * 5
    ok_sig = np.zeros(512, np.float32)
    enc = BatchEncoder(pipeline=False, device=CPU)
    with pytest.raises(ValueError, match="histogram gap"):
        enc.encode([gap_sig, ok_sig], tables).to_host()
    out = enc.encode([gap_sig, ok_sig], tables, quarantine=True).to_host()
    assert isinstance(out[0], PoisonedContainerError)
    assert out[0].fault == "histogram-gap"
    solo = enc.encode([ok_sig], tables).to_host()
    assert out[1].to_bytes() == solo[0].to_bytes()


def test_all_poisoned_batch_drains_typed(serving_tables):
    dec = BatchDecoder(pipeline=False, device=CPU)
    out = dec.decode([_frozen("bad-magic"), _frozen("flip-crc")],
                     serving_tables, quarantine=True).to_host()
    assert all(isinstance(o, PoisonedContainerError) for o in out)


# ---------------------------------------------------------------------------
# Dispatcher fault injection: retry + watchdog.
# ---------------------------------------------------------------------------
def _frontend(tables, injector=None, **cfg):
    return ServingFrontend(tables, pipeline=False, device=CPU,
                           fault_injector=injector,
                           config=FrontendConfig(**cfg))


def test_injector_counts_and_fires_on_nth():
    inj = DispatcherFaultInjector(fail_on={2})
    inj.on_dispatch(("decode", ()), [])
    with pytest.raises(InjectedDispatchError):
        inj.on_dispatch(("decode", ()), [])
    inj.on_dispatch(("decode", ()), [])
    assert inj.dispatches == 3
    assert inj.injected == [(2, "fail")]


def test_retry_absorbs_transient_fault(serving_tables):
    sig = np.random.default_rng(4).standard_normal(300).astype(np.float32)
    inj = DispatcherFaultInjector(fail_on={2})  # 1: encode, 2: decode fails
    with _frontend(serving_tables, inj,
                   retry=RetryPolicy(max_retries=2, base_backoff_ms=1.0)
                   ) as fe:
        blob = fe.submit_encode(sig).result(60).to_bytes()
        ref = fe.submit_decode(blob)
        fe.flush()
        np.testing.assert_array_equal(
            ref.result(60),
            BatchDecoder(pipeline=False, device=CPU).decode(
                [Container.from_bytes(blob)], serving_tables).to_host()[0],
        )
        stats = fe.stats_snapshot()
        assert stats.retries >= 1
        assert stats.retry_successes >= 1
        assert stats.failed == 0


def test_retry_exhaustion_is_typed_dispatch_failure(serving_tables):
    sig = np.random.default_rng(5).standard_normal(300).astype(np.float32)
    inj = DispatcherFaultInjector(fail_on={2, 3, 4})
    with _frontend(serving_tables, inj,
                   retry=RetryPolicy(max_retries=2, base_backoff_ms=1.0)
                   ) as fe:
        blob = fe.submit_encode(sig).result(60).to_bytes()
        fut = fe.submit_decode(blob)
        fe.flush()
        with pytest.raises(DispatchFailedError) as exc:
            fut.result(60)
        assert isinstance(exc.value.__cause__, InjectedDispatchError)
        assert fe.stats_snapshot().dispatch_failures == 1
        assert fe.health()["status"] == "degraded"


def test_retry_never_reruns_poisoned_payloads(serving_tables):
    sig = np.random.default_rng(6).standard_normal(300).astype(np.float32)
    with _frontend(serving_tables) as fe:
        blob = fe.submit_encode(sig).result(60).to_bytes()
        fut = fe.submit_decode(corrupt(blob, "flip-words", seed=7))
        fe.flush()
        with pytest.raises(PoisonedContainerError):
            fut.result(60)
        stats = fe.stats_snapshot()
        assert stats.retries == 0
        assert stats.quarantined == 1


def test_watchdog_cuts_hung_dispatch_and_frontend_survives(serving_tables):
    sig = np.random.default_rng(7).standard_normal(300).astype(np.float32)
    inj = DispatcherFaultInjector(hang_on={2}, hang_timeout_s=30.0)
    try:
        with _frontend(serving_tables, inj, watchdog_timeout_ms=1500.0,
                       watchdog_poll_ms=25.0,
                       retry=RetryPolicy(max_retries=1, base_backoff_ms=1.0)
                       ) as fe:
            blob = fe.submit_encode(sig).result(60).to_bytes()
            hung = fe.submit_decode(blob)
            fe.flush()
            with pytest.raises(DispatchFailedError, match="watchdog"):
                hung.result(30)
            # the replacement dispatcher generation keeps draining
            again = fe.submit_decode(blob)
            fe.flush()
            assert again.result(60).shape == sig.shape
            assert fe.stats_snapshot().watchdog_restarts == 1
            health = fe.health()
            assert health["status"] == "degraded"
            assert health["watchdog_restarts"] == 1
    finally:
        inj.release()  # unblock the abandoned dispatcher, and let it end
        _join_abandoned_dispatchers()


def _join_abandoned_dispatchers():
    """Join the dispatcher a watchdog restart abandoned (generation 0; the
    replacements carry a ``-g<n>`` suffix and end with ``close()``), so no
    thread runs the engines while the interpreter shuts down."""
    for t in threading.enumerate():
        if t.name == "fptc-frontend-dispatch":
            t.join(30)
            assert not t.is_alive()


def test_health_ok_and_sheds_reported(serving_tables):
    with _frontend(serving_tables) as fe:
        h = fe.health()
        assert h["status"] == "ok"
        assert h["shed_rate"] == 0.0
        assert h["quarantined"] == 0


# ---------------------------------------------------------------------------
# The launch counters the frontend's dispatcher threads share.
# ---------------------------------------------------------------------------
def test_launch_counter_survives_two_threads(monkeypatch):
    """Two threads add to one kernel's counter at once (as two dispatcher
    generations can after a watchdog restart), with a short switch
    interval: no increment is lost.  The counter takes a lock, so this
    holds on any interpreter, a free-threaded one included."""
    import sys

    monkeypatch.setitem(ops.LAUNCHES, "symlen_decode", 0)
    per_thread = 20000
    start = threading.Barrier(2)

    def bump():
        start.wait(10)
        for _ in range(per_thread):
            ops._count_launch("symlen_decode")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert ops.LAUNCHES["symlen_decode"] == 2 * per_thread
