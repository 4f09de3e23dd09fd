"""The port's synthetic open-loop traffic held against the JAX package's.

One ``TrafficConfig`` seed must give the reference's stream: the same
arrival times, kinds, domains, datasets, sizes, transcode targets and
encode signals, and — with the reference's tables carried across through
``tables_from_arrays`` — pre-encoded containers equal byte for byte to the
reference's encoder's wherever the two packages quantize to the same
levels.  torch's CPU DCT sums in another order than XLA's, so a
coefficient on a quantizer cell boundary can land one level away (one
cell of 11456 in the first stream below; ``ROADMAP.md`` queue 3): those
containers are held by the flip rule of ``tests/test_torch_transcode.py``
(``assert_matches_reference``).  ``replay`` must account for every request
once: completed, shed or rejected at admission.  The pre-encode runs on
``device="cpu"`` (the plain versions).
"""
import dataclasses

import pytest

pytest.importorskip("jax")  # the reference; absent on the card

import numpy as np  # noqa: E402

from repro.serving import traffic as ref_traffic  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DOMAIN_DATASETS,
    FrontendConfig,
    ReplayReport,
    ServingFrontend,
    TrafficConfig,
    generate,
    replay,
)
from test_torch_transcode import (  # noqa: E402
    assert_matches_reference,
    carry,
)

CPU = "cpu"


@pytest.fixture(scope="module")
def tables():
    """(reference, port) tables for the four paper domains, calibrated by
    the reference's ``build_domain_tables`` on a short strip."""
    ref = ref_traffic.build_domain_tables(calib_len=8192)
    return ref, {d: carry(t) for d, t in ref.items()}


def _same_stream(cfg, tables):
    ref_tab, tab = tables
    want = ref_traffic.generate(
        ref_traffic.TrafficConfig(**dataclasses.asdict(cfg)), ref_tab)
    got = generate(cfg, tab, device=CPU)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.arrival == w.arrival
        assert (g.kind, g.domain_id, g.dataset, g.num_windows,
                g.dst_domain_id) == (w.kind, w.domain_id, w.dataset,
                                     w.num_windows, w.dst_domain_id)
        if w.signal is None:
            assert g.signal is None
        else:
            assert g.signal.dtype == w.signal.dtype
            assert np.array_equal(g.signal, w.signal)
        assert (g.container is None) == (w.container is None)
    pairs = [(g.container, w.container) for g, w in zip(got, want)
             if w.container is not None]
    if pairs:
        assert_matches_reference(*zip(*pairs), tab)
    return got


def test_domain_datasets_match_the_reference():
    assert DOMAIN_DATASETS == ref_traffic.DOMAIN_DATASETS


def test_one_seed_gives_the_reference_stream(tables):
    """Log-normal sizes over the four domains, every kind: the reference's
    arrivals, kinds, domains, sizes, targets and bytes."""
    cfg = TrafficConfig(rate=120.0, duration_s=0.4, seed=5)
    got = _same_stream(cfg, tables)
    assert {r.kind for r in got} == {"decode", "encode", "transcode"}
    # the seismic floor: its generator needs 255 samples
    assert all(r.num_windows * 32 >= 255 for r in got
               if r.dataset == "seismic")


def test_fixed_windows_and_domain_subset(tables):
    cfg = TrafficConfig(rate=200.0, duration_s=0.3, fixed_windows=8,
                        domains=(2, 3), seed=9,
                        mix={"decode": 0.5, "encode": 0.3, "transcode": 0.2})
    got = _same_stream(cfg, tables)
    assert {r.domain_id for r in got} <= {2, 3}
    assert all(r.num_windows == 8 for r in got)
    assert all(r.dst_domain_id != r.domain_id for r in got
               if r.kind == "transcode")


def test_single_domain_transcode_reencodes_in_place(tables):
    cfg = TrafficConfig(rate=100.0, duration_s=0.2, fixed_windows=4,
                        domains=(1,), seed=2, mix={"transcode": 1.0})
    got = _same_stream(cfg, tables)
    assert all(r.dst_domain_id == 1 for r in got)


def test_config_is_checked_like_the_reference():
    for bad in (dict(rate=0.0), dict(mix={"decode": -1.0}),
                dict(mix={"upload": 1.0})):
        with pytest.raises(ValueError):
            TrafficConfig(**bad)
        with pytest.raises(ValueError):
            ref_traffic.TrafficConfig(**bad)


def test_replay_accounts_for_every_request(tables):
    """Completed, shed and rejected at admission add up to the stream, and
    the summary carries the reference's fields."""
    _, tab = tables
    cfg = TrafficConfig(rate=300.0, duration_s=0.3, fixed_windows=4,
                        domains=(0, 1), seed=4,
                        mix={"decode": 0.6, "encode": 0.4})
    reqs = generate(cfg, tab, device=CPU)
    with ServingFrontend(tab, device=CPU, config=FrontendConfig(
            default_slo_ms=10_000.0)) as fe:
        ok = replay(fe, reqs)
    assert ok.submitted == ok.completed == len(reqs)
    assert ok.shed == ok.rejected_expired == ok.failed == 0
    assert len(ok.latencies_ms) == len(reqs)
    assert ok.p50_ms <= ok.percentile(95) <= ok.p99_ms
    assert set(ok.summary()) == set(ref_traffic.ReplayReport(
        0.0, 0.0, 0, 0, 0, 0, 0, [], 0.0).summary())
    # a queue bound of 1 and deadlines an hour out: past the first request
    # of each queue, every admission sheds, and what was admitted completes
    with ServingFrontend(tab, device=CPU, config=FrontendConfig(
            max_batch=8, max_queue_depth=1,
            default_slo_ms=3_600_000.0)) as fe:
        shed = replay(fe, reqs)
    assert shed.shed > 0
    assert shed.shed + shed.submitted == len(reqs)
    assert shed.completed == shed.submitted
    # an expired deadline is rejected at admission, never enqueued
    with ServingFrontend(tab, device=CPU) as fe:
        late = replay(fe, reqs, deadline_ms=0.0)
    assert late.rejected_expired == len(reqs)
    assert late.submitted == late.completed == 0
    assert np.isnan(late.p99_ms)
    assert ReplayReport(0.0, 0.0, 0, 0, 0, 0, 0, [], 0.0).achieved_rps == 0.0


def test_replay_times_admission_flush_and_collections(tables):
    """The replay's timings: one admission lag per admitted request, one
    flush-to-result time per completed one, and the process's garbage
    collections during the replay (a full collection forced inside each
    dispatch is seen as one), its callback gone afterwards; and
    ``settle_heap`` freezes the live heap until ``gc.unfreeze``."""
    import gc

    from repro_torch.serving import settle_heap

    _, tab = tables
    cfg = TrafficConfig(rate=300.0, duration_s=0.2, fixed_windows=4,
                        domains=(0, 1), seed=9,
                        mix={"decode": 0.5, "encode": 0.5})
    reqs = generate(cfg, tab, device=CPU)

    class Collect:
        def on_dispatch(self, key, members):
            gc.collect()

    callbacks = list(gc.callbacks)
    with ServingFrontend(tab, device=CPU, fault_injector=Collect(),
                         config=FrontendConfig(
                             default_slo_ms=10_000.0)) as fe:
        rep = replay(fe, reqs)
    assert gc.callbacks == callbacks
    assert rep.completed == rep.submitted == len(reqs)
    assert len(rep.admit_lag_ms) == len(rep.admit_at_s) == rep.submitted
    assert len(rep.flush_to_result_ms) == rep.completed
    assert min(rep.flush_to_result_ms) >= 0.0
    assert all(0.0 <= t <= rep.wall_s for t in rep.admit_at_s)
    t = rep.timings()
    assert t["admit_lag_p50_ms"] <= t["admit_lag_p99_ms"]
    assert t["flush_to_result_p50_ms"] <= t["flush_to_result_p99_ms"]
    assert t["gc_full_collections"] >= 1 and t["gc_max_ms"] > 0.0
    assert t["late_admits_in_gc"] <= t["late_admits"]
    try:
        assert settle_heap() == gc.get_freeze_count() > 0
    finally:
        gc.unfreeze()
    assert gc.get_freeze_count() == 0
