"""The port's serving quarantine held against the JAX package.

Each frozen corrupt blob of ``tests/golden/corrupt/`` must get the fault
class, byte offset and index that the reference's ``validate_or_poison``
gives it — ``flip-header`` and ``wrong-table`` included, which parse
cleanly and are caught only by the deep checks — and the same typed
outcome out of the engines' ``quarantine=True`` drains.  A batch with
poisoned slots must decode, encode and transcode its clean slots exactly
as a clean run of the port does (byte for byte, and sample for sample),
and like the reference: decoded samples within ``1e-5 * max|ref|`` of its
XLA engine arm, containers byte-equal to its encoder.  ``device="cpu"``
runs every kernel wrapper's plain version."""
import dataclasses
import os

import pytest

jnp = pytest.importorskip("jax.numpy")  # the reference; absent on the card

import numpy as np  # noqa: E402

from _synth import gap_tables, golden_tables  # noqa: E402
from repro.core import DOMAIN_DEFAULTS
from repro.core import calibrate as ref_calibrate
from repro.data import make_signal
from repro.serving import BatchDecoder as RefBatchDecoder
from repro.serving import BatchEncoder as RefBatchEncoder
from repro.serving import Transcoder as RefTranscoder
from repro.serving import quarantine as ref_quarantine
from repro_torch.testing.faults import CONTAINER_FAULTS, EXPECTED_FAULT, corrupt
from repro_torch.core.calibration import tables_from_arrays
from repro_torch.core.container import Container
from repro_torch.serving import (
    BatchDecoder,
    BatchEncoder,
    PoisonedContainerError,
    Transcoder,
    quarantine,
)

CORRUPT_DIR = os.path.join(os.path.dirname(__file__), "golden", "corrupt")
REL_TOL = 1e-5


def carry(ref_tables):
    q = ref_tables.quant
    return tables_from_arrays(
        dataclasses.asdict(ref_tables.config), ref_tables.domain_id,
        zone=np.asarray(q.zone), scale=np.asarray(q.scale), mu=float(q.mu),
        alpha1=float(q.alpha1), lengths=np.asarray(ref_tables.book.lengths),
    )


def frozen(fault: str) -> bytes:
    with open(os.path.join(CORRUPT_DIR, f"{fault}.fptc"), "rb") as f:
        return f.read()


def blob_tables(fault):
    """The golden tables each blob was cut from (as the reference's
    ``tests/test_faults.py`` pairs them): (reference, port)."""
    ref = golden_tables("power", 2, v3=fault == "reserved-flags")
    return ref, carry(ref)


@pytest.fixture(scope="module")
def serving():
    """Calibrated power tables and meteorological target tables, in both
    packages, and five seeded signals encoded by the port."""
    ref = {
        0: ref_calibrate(make_signal("load_power", 65536, seed=7),
                         DOMAIN_DEFAULTS["power"], domain_id=0),
        1: ref_calibrate(make_signal("temperature", 65536, seed=8),
                         DOMAIN_DEFAULTS["meteorological"], domain_id=1),
    }
    tabs = {k: carry(t) for k, t in ref.items()}
    rng = np.random.default_rng(0)
    sigs = [rng.standard_normal(500).astype(np.float32) for _ in range(5)]
    blobs = [c.to_bytes() for c in BatchEncoder(device="cpu").encode(
        sigs, tabs[0]).to_host()]
    return ref, tabs, sigs, blobs


@pytest.mark.parametrize("fault", CONTAINER_FAULTS)
def test_frozen_blob_poisons_like_the_reference(fault):
    ref_tab, tab = blob_tables(fault)
    want_c, want = ref_quarantine.validate_or_poison(frozen(fault), 5,
                                                     ref_tab)
    got_c, got = quarantine.validate_or_poison(frozen(fault), 5, tab)
    assert want_c is None and got_c is None
    assert isinstance(got, PoisonedContainerError)
    assert got.fault == want.fault and got.fault in EXPECTED_FAULT[fault]
    assert (got.offset, got.index) == (want.offset, want.index)
    assert got.index == 5
    assert str(got) == str(want)
    # the engine's drain delivers the same typed outcome
    out = BatchDecoder(device="cpu", pipeline=False).decode(
        [frozen(fault)], tab, quarantine=True).to_host()
    ref_out = RefBatchDecoder(use_kernels=False, devices=None,
                              pipeline=False).decode(
        [frozen(fault)], ref_tab, quarantine=True).to_host()
    assert isinstance(out[0], PoisonedContainerError)
    assert out[0].fault == ref_out[0].fault


def test_deep_checks_catch_what_parses():
    """``flip-header`` and ``wrong-table`` parse cleanly; only the deep
    checks poison them."""
    for fault in ("flip-header", "wrong-table"):
        ref_tab, tab = blob_tables(fault)
        c = Container.from_bytes(frozen(fault))
        with pytest.raises(PoisonedContainerError) as got:
            quarantine.validate_container(c, tab, index=2)
        assert got.value.fault in EXPECTED_FAULT[fault]
        assert got.value.index == 2


def test_clean_blob_validates_and_routing_faults():
    ref_tab, tab = blob_tables("flip-crc")
    with open(os.path.join(os.path.dirname(CORRUPT_DIR),
                           "power_v2.fptc"), "rb") as f:
        golden = f.read()
    c, err = quarantine.validate_or_poison(golden, 0, tab)
    assert err is None and c.to_bytes() == golden
    c2, err = quarantine.validate_or_poison(c, 1, {tab.domain_id: tab})
    assert err is None and c2 is c
    _, err = quarantine.validate_or_poison(golden, 3, {99: tab})
    _, ref_err = ref_quarantine.validate_or_poison(golden, 3, {99: ref_tab})
    assert err.fault == ref_err.fault == quarantine.FAULT_UNROUTABLE
    for exc in (KeyError("x"), ValueError("plan_key (1, 2) does not match"),
                ValueError("histogram gap"), RuntimeError("boom")):
        assert quarantine.classify_fault(exc) == \
            ref_quarantine.classify_fault(exc)


def test_decode_excludes_poison_and_keeps_batch_identical(serving):
    ref, tabs, _, blobs = serving
    dec = BatchDecoder(device="cpu", pipeline=False)
    clean = dec.decode([Container.from_bytes(b) for b in blobs],
                       tabs[0]).to_host()
    items = list(blobs)
    items[1] = corrupt(blobs[1], "flip-words", seed=2)
    items[3] = corrupt(blobs[3], "truncate", seed=2)
    batch = dec.decode(items, tabs[0], quarantine=True)
    with pytest.raises(PoisonedContainerError):
        batch.device_signal(1)
    np.testing.assert_array_equal(batch.device_signal(0).numpy(), clean[0])
    out = batch.to_host()
    assert [o.index for o in (out[1], out[3])] == [1, 3]
    for i in (0, 2, 4):
        np.testing.assert_array_equal(out[i], clean[i])
    assert dec.stats.quarantined == 2
    ref_out = RefBatchDecoder(use_kernels=False, devices=None,
                              pipeline=False).decode(
        items, ref[0], quarantine=True).to_host()
    for i in (1, 3):
        assert out[i].fault == ref_out[i].fault
    for i in (0, 2, 4):
        r = np.asarray(ref_out[i])
        assert np.abs(out[i] - r).max() <= REL_TOL * np.abs(r).max()
    # the incremental surface, and an all-poisoned batch
    for item in items:
        dec.submit(item)
    again = dec.flush(tabs[0], quarantine=True).to_host()
    for i in (0, 2, 4):
        np.testing.assert_array_equal(again[i], clean[i])
    out = dec.decode([frozen("bad-magic"), frozen("flip-crc")], tabs[0],
                     quarantine=True).to_host()
    assert all(isinstance(o, PoisonedContainerError) for o in out)


def test_encode_demotes_histogram_gap_per_signal():
    """Batch-fatal offline; under quarantine a per-signal typed outcome,
    and the clean co-batched signal's bytes equal encoding it alone (and
    the reference's)."""
    ref_tab = gap_tables()
    tab = carry(ref_tab)
    gap_sig = (np.sin(np.linspace(0, 30, 512)) * 5).astype(np.float32)
    ok_sig = np.zeros(512, np.float32)
    enc = BatchEncoder(device="cpu", pipeline=False)
    with pytest.raises(ValueError, match="histogram gap"):
        enc.encode([gap_sig, ok_sig], tab).to_host()
    out = enc.encode([gap_sig, ok_sig], tab, quarantine=True).to_host()
    assert isinstance(out[0], PoisonedContainerError)
    assert out[0].fault == quarantine.FAULT_HISTOGRAM_GAP
    assert out[0].index == 0
    solo = enc.encode([ok_sig], tab).to_host()[0]
    assert out[1].to_bytes() == solo.to_bytes()
    ref_out = RefBatchEncoder(use_kernels=False, devices=None,
                              pipeline=False).encode(
        [gap_sig, ok_sig], ref_tab, quarantine=True).to_host()
    assert out[0].fault == ref_out[0].fault
    assert str(out[0]) == str(ref_out[0])
    assert out[1].to_bytes() == ref_out[1].to_bytes()
    enc.submit(gap_sig)
    enc.submit(ok_sig)
    again = enc.flush(tab, quarantine=True).to_host()
    assert isinstance(again[0], PoisonedContainerError)
    assert again[1].to_bytes() == solo.to_bytes()


def test_transcode_excludes_poison_byte_identical(serving):
    ref, tabs, sigs, blobs = serving
    tc = Transcoder(device="cpu", pipeline=False)
    clean = tc.transcode([Container.from_bytes(b) for b in blobs[:3]], tabs,
                         tabs, dst_domain_ids=[1, 1, 1]).to_host()
    items = [blobs[0], corrupt(blobs[1], "flip-sidecar", seed=3), blobs[2]]
    out = tc.transcode(items, tabs, tabs, dst_domain_ids=[1, 1, 1],
                       quarantine=True).to_host()
    assert isinstance(out[1], PoisonedContainerError)
    assert out[1].fault == quarantine.FAULT_CRC_MISMATCH
    assert out[0].to_bytes() == clean[0].to_bytes()
    assert out[2].to_bytes() == clean[2].to_bytes()
    assert tc.stats.quarantined == 1
    ref_out = RefTranscoder(
        use_kernels=False, devices=None, pipeline=False).transcode(
        items, ref, ref, dst_domain_ids=[1, 1, 1], quarantine=True).to_host()
    assert out[1].fault == ref_out[1].fault
    # the incremental surface routes the same way
    for item in items:
        tc.submit(item, 1)
    again = tc.flush(tabs, tabs, quarantine=True).to_host()
    assert isinstance(again[1], PoisonedContainerError)
    assert again[0].to_bytes() == clean[0].to_bytes()
    # every slot poisoned: a typed outcome per slot, nothing to encode
    out = tc.transcode([frozen("bad-magic"), frozen("truncate")], tabs, tabs,
                       quarantine=True).to_host()
    assert [o.fault for o in out] == ["bad-magic", "truncated"]
