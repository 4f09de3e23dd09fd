"""The port's host codec and calibration held against the JAX package.

Tables are carried across with ``tables_from_arrays`` (config fields, quant
table, code lengths).  Bytes and integer tables are exact.  Float bound,
stated against the reference host decode ``repro.core.codec.decode``:
``max|d| <= 1e-5 * max|ref|`` (the reference's own two decode arms differ
by up to 7.6e-6 absolute on this tree)."""
import dataclasses
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent on the card

from _synth import GOLDEN_DOMAINS, golden_signal, golden_tables
from repro.core import codec as ref_codec
from repro.core import quantize as ref_quantize
from repro.core.container import Container as RefContainer
from repro.data import make_signal as ref_make_signal
from repro_torch.core import codec, quantize
from repro_torch.core.calibration import (
    calibrate,
    tables_from_arrays,
    tables_from_hist,
)
from repro_torch.core.config import DOMAIN_DEFAULTS
from repro_torch.core.container import Container
from repro_torch.data import make_signal

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
REL_TOL = 1e-5


def carry(ref_tables):
    """A reference DomainTables -> the port's, through plain numbers."""
    q = ref_tables.quant
    return tables_from_arrays(
        dataclasses.asdict(ref_tables.config),
        ref_tables.domain_id,
        zone=np.asarray(q.zone),
        scale=np.asarray(q.scale),
        mu=float(q.mu),
        alpha1=float(q.alpha1),
        lengths=np.asarray(ref_tables.book.lengths),
    )


def _read(name):
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        return f.read()


def assert_close(got, ref, rel=REL_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max(initial=0.0) <= rel * max(
        np.abs(ref).max(initial=0.0), 1e-30
    )


@pytest.mark.parametrize("domain_key,dom_id", GOLDEN_DOMAINS)
def test_tables_from_arrays_match_reference(domain_key, dom_id):
    """Every table derived from the carried state equals the reference's:
    codewords, canonical decode tables and the LUT exactly, the dequant LUT
    (``quant_grid``) within ``2e-7 * max|ref|``."""
    for v3 in (False, True):
        ref = golden_tables(domain_key, dom_id, v3=v3)
        port = carry(ref)
        assert port.config.__dict__ == ref.config.__dict__
        assert port.config.coding == ref.config.coding
        for name in ("codes", "lengths", "limit_shifted",
                     "first_code_shifted", "rank_offset", "sorted_symbols",
                     "lut_symbol", "lut_length"):
            np.testing.assert_array_equal(
                getattr(port.book, name), getattr(ref.book, name)
            )
        ref_dev, dev = ref.device_tables(), port.device_tables("cpu")
        for name in ("codes", "lengths", "dec_limit", "dec_first",
                     "dec_rank", "dec_syms"):
            np.testing.assert_array_equal(
                getattr(dev, name).numpy(), np.asarray(getattr(ref_dev, name))
            )
        ref_grid = np.asarray(ref_quantize.quant_grid(ref.quant)[0])
        grid = quantize.quant_grid(port.quant)[0].numpy()
        # the same float32 formula; torch's and XLA's expm1/log1p round
        # differently (up to 5 ulp in the mu-law zone on these tables)
        assert_close(grid, ref_grid, rel=2e-7)


@pytest.mark.parametrize("version", [2, 3])
@pytest.mark.parametrize("domain_key,dom_id", GOLDEN_DOMAINS)
def test_encode_reproduces_golden_bytes(domain_key, dom_id, version):
    """The port's host encoder emits the frozen blob byte for byte from the
    golden signal."""
    ref_tables = golden_tables(domain_key, dom_id, v3=version == 3)
    _, sig = golden_signal(ref_tables)
    c = codec.encode(sig, carry(ref_tables))
    assert c.version == version
    assert c.to_bytes() == _read(f"{domain_key}_v{version}.fptc")


@pytest.mark.parametrize("version", [1, 2, 3])
@pytest.mark.parametrize("domain_key,dom_id", GOLDEN_DOMAINS)
def test_host_decode_matches_reference(domain_key, dom_id, version):
    ref_tables = golden_tables(domain_key, dom_id, v3=version == 3)
    blob = _read(f"{domain_key}_v{version}.fptc")
    got = codec.decode(Container.from_bytes(blob), carry(ref_tables))
    ref = ref_codec.decode(RefContainer.from_bytes(blob), ref_tables)
    assert_close(got, ref)


@pytest.mark.parametrize("domain_key,dom_id", GOLDEN_DOMAINS)
def test_v3_decodes_identically_to_v2(domain_key, dom_id):
    """v3 is a lossless re-coding: the v3 blob reconstructs exactly the v2
    blob's samples, on the host decoder and the batched engine."""
    t2 = carry(golden_tables(domain_key, dom_id))
    t3 = carry(golden_tables(domain_key, dom_id, v3=True))
    c2 = Container.from_bytes(_read(f"{domain_key}_v2.fptc"))
    c3 = Container.from_bytes(_read(f"{domain_key}_v3.fptc"))
    ref = codec.decode(c2, t2)
    np.testing.assert_array_equal(codec.decode(c3, t3), ref)
    np.testing.assert_array_equal(
        codec.decode_device(c3, t3, device="cpu"),
        codec.decode_device(c2, t2, device="cpu"),
    )


def test_decode_rejects_mismatched_tables():
    c = Container.from_bytes(_read("power_v2.fptc"))
    wrong = carry(golden_tables("meteorological", 3))
    with pytest.raises(ValueError, match="plan_key"):
        codec.decode(c, wrong)
    with pytest.raises(ValueError, match="plan_key"):
        codec.decode_device(c, wrong, device="cpu")


def test_decode_device_defaults_to_the_card():
    """decode_device with no device runs on the card, and raises where
    there is none — it never falls back to the CPU quietly."""
    tables = carry(golden_tables("power", 2))
    c = Container.from_bytes(_read("power_v2.fptc"))
    if torch.cuda.is_available():
        out = codec.decode_device(c, tables)
        assert_close(out, codec.decode(c, tables))
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            codec.decode_device(c, tables)


@pytest.mark.parametrize("coding", [
    {}, dict(predictor="delta", predict_bands=2, zero_planes=True),
    dict(predictor="linear2", predict_bands=3, zero_planes=False),
])
def test_calibrate_and_roundtrip_against_reference(coding):
    """The port's calibration builds the reference's quant table (within
    float32 percentile noise) and codebook on the same strip, and a host
    encode of reference-carried tables decodes like the reference."""
    from repro.core.calibration import calibrate as ref_calibrate

    cfg = DOMAIN_DEFAULTS["power"].replace(**coding)
    # the strip and the signal share one length, so the reference's eager
    # ops compile once for both
    strip = make_signal("load_power", 8192, seed=3)
    np.testing.assert_array_equal(strip, ref_make_signal("load_power",
                                                         8192, seed=3))
    ref_tables = ref_calibrate(strip, cfg, domain_id=2)
    port_tables = calibrate(strip, cfg, domain_id=2)
    np.testing.assert_allclose(
        port_tables.quant.scale.numpy(), np.asarray(ref_tables.quant.scale),
        rtol=1e-5,
    )
    np.testing.assert_array_equal(
        port_tables.quant.zone.numpy(), np.asarray(ref_tables.quant.zone)
    )
    # float32 noise may flip a level at a cell boundary (and, under a
    # predictor, the residuals that depend on it): a few symbols at most
    assert port_tables.hist.sum() == ref_tables.hist.sum()
    assert np.abs(port_tables.hist - ref_tables.hist).sum() <= (
        0.01 * ref_tables.hist.sum()
    )

    tables = carry(ref_tables)
    sig = make_signal("load_power", 8192, seed=4)
    c = codec.encode(sig, tables)
    ref_c = ref_codec.encode(sig, ref_tables)
    assert c.plan_key == ref_c.plan_key
    assert_close(codec.decode(c, tables), ref_codec.decode(ref_c, ref_tables),
                 rel=2e-2)


def test_tables_from_hist_matches_calibration():
    cfg = DOMAIN_DEFAULTS["biomedical"]
    t = calibrate(make_signal("mitbih", 8192, seed=1), cfg, domain_id=4)
    again = tables_from_hist(cfg, t.quant.scale.numpy(), t.hist, domain_id=4)
    np.testing.assert_array_equal(again.book.codes, t.book.codes)
    np.testing.assert_array_equal(again.quant.zone.numpy(),
                                  t.quant.zone.numpy())


@pytest.mark.parametrize("domain_key,dom_id", GOLDEN_DOMAINS)
def test_roundtrip_metrics_match_reference(domain_key, dom_id):
    """``codec.roundtrip_metrics`` (on the port's ``core/metrics.py``)
    against the reference's on the golden signal: the compression ratio
    exactly (the bytes are the golden blob's), the PRD within 1e-4 of it
    (the two host decodes differ by at most 1e-5 of the signal's range)."""
    ref_tables = golden_tables(domain_key, dom_id)
    _, sig = golden_signal(ref_tables)
    cr, prd = codec.roundtrip_metrics(sig, carry(ref_tables))
    ref_cr, ref_prd = ref_codec.roundtrip_metrics(sig, ref_tables)
    assert cr == ref_cr
    assert abs(prd - ref_prd) <= 1e-4 * max(ref_prd, 1.0)


def test_metrics_match_reference():
    """prd, nrmse, snr_db and compression_ratio against the reference's on
    the same arrays, the degenerate cases (exact, all-zero and constant
    signals, an empty stream) included."""
    from repro.core import metrics as ref_metrics
    from repro_torch.core import metrics

    rng = np.random.default_rng(5)
    x = rng.standard_normal(4096).astype(np.float32)
    noisy = x + np.float32(0.01) * rng.standard_normal(4096).astype(
        np.float32)
    zeros, const = np.zeros(64, np.float32), np.full(64, 3.0, np.float32)
    pairs = [(x, noisy), (x, x), (zeros, zeros), (zeros, const),
             (const, const), (const, zeros)]
    for name in ("prd", "nrmse", "snr_db"):
        for a, b in pairs:
            assert (getattr(metrics, name)(a, b)
                    == getattr(ref_metrics, name)(a, b)), (name, a[:2], b[:2])
    for sizes in ((1 << 20, 4321), (100, 0), (0, 7)):
        assert (metrics.compression_ratio(*sizes)
                == ref_metrics.compression_ratio(*sizes))
    with pytest.raises(ValueError, match="shape mismatch"):
        metrics.prd(x, noisy[:-1])
