"""The chaos soak on the port: the twins of ``tests/test_chaos.py`` (less
its sharded leg — the port serves from one device), on ``device="cpu"``.

An open-loop multi-thousand-request replay with seeded payload corruption
and dispatcher sabotage must keep the whole fault-isolation contract:
zero silent drops (the ``ChaosReport`` accounting is closed), zero hangs,
typed poison for every corrupted container, and every clean result equal
to the port's offline engines bit for bit.  The harness itself is held to
the reference: ``corrupt`` gives the reference's bytes for every fault
class and seeds 0-2, and the offline oracle's samples are within
``1e-5 * max|ref|`` of the reference's offline XLA arm
(``BatchDecoder(use_kernels=False)``) on the same container bytes.  The
soak on the card: ``chip_smoke.py``'s serve phase.
"""
import os

import pytest

pytest.importorskip("jax")  # the reference; absent on the card

import numpy as np  # noqa: E402

from repro.core import DOMAIN_DEFAULTS  # noqa: E402
from repro.core import calibrate as ref_calibrate  # noqa: E402
from repro.core.container import Container as RefContainer  # noqa: E402
from repro.data import make_signal  # noqa: E402
from repro.serving import BatchDecoder as RefBatchDecoder  # noqa: E402
from repro.testing import faults as ref_faults  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DOMAIN_DATASETS,
    BatchDecoder,
    FrontendConfig,
    RetryPolicy,
    ServingFrontend,
    TrafficConfig,
    generate,
)
from repro_torch.testing.faults import (  # noqa: E402
    CONTAINER_FAULTS,
    EXPECTED_FAULT,
    ChaosReport,
    DispatcherFaultInjector,
    chaos_replay,
    corrupt,
    offline_expected,
)
from test_torch_faults import _join_abandoned_dispatchers  # noqa: E402
from test_torch_transcode import carry  # noqa: E402

CHAOS_SEED = 1303
CPU = "cpu"
REL_TOL = 1e-5


@pytest.fixture(scope="module")
def ref_tables():
    """Two serving domains with different configs (power e = 6,
    meteorological e = 8), so a flipped domain id lands on plan-mismatch,
    calibrated by the reference."""
    tables = {}
    for domain_id in (2, 3):
        domain, dataset = DOMAIN_DATASETS[domain_id]
        tables[domain_id] = ref_calibrate(
            make_signal(dataset, 32768, seed=1000 + domain_id),
            DOMAIN_DEFAULTS[domain], domain_id=domain_id)
    return tables


@pytest.fixture(scope="module")
def chaos_tables(ref_tables):
    return {d: carry(t) for d, t in ref_tables.items()}


def _stream(tables, **kw):
    return generate(TrafficConfig(**kw), tables, device=CPU)


def _frontend(tables, injector=None, **cfg):
    return ServingFrontend(tables, device=CPU, fault_injector=injector,
                           config=FrontendConfig(**cfg))


# ---------------------------------------------------------------------------
# The soak.
# ---------------------------------------------------------------------------
def test_chaos_soak_typed_outcomes_and_byte_identity(chaos_tables):
    requests = _stream(
        chaos_tables, rate=2400.0, duration_s=1.0, fixed_windows=8,
        mix={"decode": 0.5, "encode": 0.3, "transcode": 0.2},
        domains=(2, 3), seed=CHAOS_SEED)
    assert len(requests) >= 2000, "soak needs a >=2k-request stream"
    expected = offline_expected(requests, chaos_tables, device=CPU)
    inj = DispatcherFaultInjector(fail_on={3, 11}, latency_on={6: 0.05},
                                  device_loss_on={17})
    with _frontend(chaos_tables, inj, max_batch=64, max_queue_depth=4096,
                   default_slo_ms=600_000.0,
                   retry=RetryPolicy(max_retries=2, base_backoff_ms=1.0)
                   ) as fe:
        report = chaos_replay(fe, requests, corrupt_frac=0.06,
                              seed=CHAOS_SEED, expected=expected,
                              result_timeout_s=600.0)
        stats = fe.stats_snapshot()
    corruptible = sum(r.kind != "encode" for r in requests)
    assert report.corrupted >= max(len(CONTAINER_FAULTS),
                                   int(0.05 * corruptible))
    assert len(inj.injected) >= 3
    assert report.accounted == report.total == len(requests)
    assert report.hangs == 0
    assert report.untyped_failures == 0
    assert report.poisoned == report.corrupted
    assert report.clean_ok == report.clean
    assert report.clean_mismatches == 0
    assert report.dispatch_failed == 0
    assert stats.retries >= 3
    assert stats.retry_successes >= 3
    admission_poison = report.total - stats.admitted
    assert stats.quarantined + admission_poison == report.corrupted
    assert stats.quarantined > 0 and admission_poison > 0


def test_chaos_hung_dispatch_resolves_typed_not_hung(chaos_tables):
    requests = _stream(chaos_tables, rate=200.0, duration_s=0.5,
                       fixed_windows=8, mix={"decode": 1.0}, domains=(2,),
                       seed=CHAOS_SEED + 1)
    assert len(requests) >= 20
    expected = offline_expected(requests, chaos_tables, device=CPU)
    inj = DispatcherFaultInjector(hang_on={2}, hang_timeout_s=120.0)
    try:
        with ServingFrontend(
                chaos_tables, device=CPU, pipeline=False, fault_injector=inj,
                config=FrontendConfig(
                    max_batch=8, max_queue_depth=4096,
                    default_slo_ms=600_000.0,
                    retry=RetryPolicy(max_retries=1, base_backoff_ms=1.0),
                    watchdog_timeout_ms=500.0, watchdog_poll_ms=25.0)) as fe:
            report = chaos_replay(fe, requests, corrupt_frac=0.0,
                                  seed=CHAOS_SEED + 1, expected=expected,
                                  result_timeout_s=600.0)
            stats = fe.stats_snapshot()
            health = fe.health()
    finally:
        inj.release()  # unblock the abandoned dispatcher, and let it end
        _join_abandoned_dispatchers()
    assert report.accounted == report.total
    assert report.hangs == 0
    assert report.untyped_failures == 0
    assert report.clean_mismatches == 0
    assert report.dispatch_failed > 0
    assert report.ok + report.dispatch_failed == report.total
    assert stats.watchdog_restarts == 1
    assert health["status"] == "degraded"
    assert any(kind == "hang" for _, kind in inj.injected)


# ---------------------------------------------------------------------------
# Harness units.
# ---------------------------------------------------------------------------
def test_chaos_replay_is_deterministic_in_seed(chaos_tables):
    requests = _stream(chaos_tables, rate=120.0, duration_s=0.5,
                       fixed_windows=4, mix={"decode": 1.0}, domains=(2,),
                       seed=CHAOS_SEED + 3)

    def outcomes():
        with _frontend(chaos_tables, max_batch=16, max_queue_depth=4096,
                       default_slo_ms=600_000.0) as fe:
            rep = chaos_replay(fe, requests, corrupt_frac=0.2,
                               seed=CHAOS_SEED + 3, result_timeout_s=600.0)
        return [(i, kind) for i, kind, _ in rep.outcomes]

    assert outcomes() == outcomes()


def test_chaos_report_accounting_identity():
    rep = ChaosReport(total=10, ok=4, poisoned=3, dispatch_failed=1,
                      rejected=1, untyped_failures=1, hangs=0)
    assert rep.accounted == 10


def test_offline_oracle_matches_traffic_payloads(ref_tables, chaos_tables):
    """The offline oracle against decoding each payload on its own: equal
    bit for bit in the port, and within ``1e-5 * max|ref|`` of the
    reference's offline XLA arm on the same container bytes (the
    reference's own twin of this test finds its arms 3.8e-6 apart;
    ``ROADMAP.md`` queue 3, R2)."""
    requests = _stream(chaos_tables, rate=60.0, duration_s=0.5,
                       fixed_windows=4, mix={"decode": 1.0}, domains=(2,),
                       seed=CHAOS_SEED + 4)
    expected = offline_expected(requests, chaos_tables, device=CPU)
    dec = BatchDecoder(pipeline=False, device=CPU)
    ref_dec = RefBatchDecoder(pipeline=False, devices=None,
                              use_kernels=False)
    for i, r in enumerate(requests):
        out = dec.decode([r.container], chaos_tables[r.domain_id]).to_host()
        np.testing.assert_array_equal(out[0], expected[i])
        ref = np.asarray(ref_dec.decode(
            [RefContainer.from_bytes(r.container.to_bytes())],
            ref_tables[r.domain_id]).to_host()[0])
        bound = REL_TOL * max(float(np.abs(ref).max()), 1e-30)
        assert float(np.abs(expected[i] - ref).max()) <= bound


@pytest.mark.parametrize("fault", CONTAINER_FAULTS)
def test_corrupt_gives_the_reference_bytes(fault):
    """The port's ``corrupt`` against the reference's, for every fault
    class and seeds 0-2, on a v2 and (for the v3-only fault) a v3 golden
    blob; the fault vocabulary equal too."""
    assert CONTAINER_FAULTS == ref_faults.CONTAINER_FAULTS
    assert EXPECTED_FAULT == ref_faults.EXPECTED_FAULT
    src = "power_v3.fptc" if fault == "reserved-flags" else "power_v2.fptc"
    with open(os.path.join(os.path.dirname(__file__), "golden", src),
              "rb") as f:
        blob = f.read()
    for seed in range(3):
        got = corrupt(blob, fault, seed=seed)
        assert got == ref_faults.corrupt(blob, fault, seed=seed)
        assert got != blob
