"""The port's host format layer held against the JAX package: the v1/v2/v3
container wire format (golden and corrupt blobs) and the canonical Huffman
codebook.  Bytes, fields and integer tables must match exactly."""
import os

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent on the card

from _synth import GOLDEN_DOMAINS
from repro.core import container as ref_container
from repro.core import huffman as ref_huffman
from repro.core.config import DOMAIN_DEFAULTS as REF_DOMAIN_DEFAULTS
from repro.testing.faults import CONTAINER_FAULTS, EXPECTED_FAULT
from repro_torch.core import container as port_container
from repro_torch.core import huffman as port_huffman
from repro_torch.core.config import DOMAIN_DEFAULTS

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
CORRUPT_DIR = os.path.join(GOLDEN_DIR, "corrupt")
GOLDEN_BLOBS = [
    f"{key}_v{v}.fptc" for key, _ in GOLDEN_DOMAINS for v in (1, 2, 3)
]

_FIELDS = (
    "num_symbols", "num_windows", "signal_length", "n", "e", "l_max",
    "domain_id", "predictor", "predict_bands", "zero_planes", "num_words",
    "max_symlen", "coding", "version", "plan_key", "compressed_bytes",
)
_BOOK_ARRAYS = (
    "lengths", "codes", "sorted_symbols", "rank_offset",
    "first_code_shifted", "limit_shifted", "lut_symbol", "lut_length",
)


def _read(*parts):
    with open(os.path.join(*parts), "rb") as f:
        return f.read()


def _assert_same_container(port, ref):
    for name in _FIELDS:
        assert getattr(port, name) == getattr(ref, name), name
    np.testing.assert_array_equal(port.words, ref.words)
    np.testing.assert_array_equal(port.symlen, ref.symlen)
    for mask in ("zrow", "zcol"):
        a, b = getattr(port, mask), getattr(ref, mask)
        assert (a is None) == (b is None), mask
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_config_defaults_match_reference():
    assert DOMAIN_DEFAULTS.keys() == REF_DOMAIN_DEFAULTS.keys()
    for key, cfg in DOMAIN_DEFAULTS.items():
        ref = REF_DOMAIN_DEFAULTS[key]
        assert cfg.__dict__ == ref.__dict__, key
        assert cfg.coding == ref.coding


@pytest.mark.parametrize("name", GOLDEN_BLOBS)
def test_golden_blob_parses_and_reserializes(name):
    """Every golden blob parses to the reference's fields and serializes to
    the reference's bytes — the blob itself for v2/v3 (v1 re-serializes in
    the current layout, as the reference does)."""
    blob = _read(GOLDEN_DIR, name)
    port = port_container.Container.from_bytes(blob)
    ref = ref_container.Container.from_bytes(blob)
    _assert_same_container(port, ref)
    assert port.to_bytes() == ref.to_bytes()
    if name.endswith("_v1.fptc"):
        assert port.to_bytes() == _read(
            GOLDEN_DIR, name.replace("_v1", "_v2")
        )
    else:
        assert port.to_bytes() == blob
    hdr = port_container.Container.peek(blob)
    assert hdr.plan_key == ref_container.Container.peek(blob).plan_key
    hi, lo = port.words_u32()
    np.testing.assert_array_equal(hi, ref.words_u32()[0])
    np.testing.assert_array_equal(lo, ref.words_u32()[1])


@pytest.mark.parametrize("fault", CONTAINER_FAULTS)
def test_corrupt_blob_raises_pinned_fault(fault):
    """Each frozen corrupt blob fails parsing exactly as the reference's
    does — same error class, fault, byte offset and index — and the fault is
    the one ``EXPECTED_FAULT`` pins.  ``flip-header`` and ``wrong-table``
    parse in both (their faults are the quarantine's header-vs-grid and
    plan checks)."""
    blob = _read(CORRUPT_DIR, f"{fault}.fptc")
    try:
        ref_container.Container.from_bytes(blob, index=7)
    except ref_container.ContainerFormatError as exc:
        ref_err = exc
    else:
        ref_err = None
    if ref_err is None:
        # caught after parsing, by the serving quarantine's deep checks
        # (ported with the front-end): both packages parse it alike, and
        # the fault is visible in the parsed fields
        assert set(EXPECTED_FAULT[fault]) <= {
            "header-mismatch", "plan-mismatch", "unroutable"
        }
        port = port_container.Container.from_bytes(blob, index=7)
        _assert_same_container(
            port, ref_container.Container.from_bytes(blob)
        )
        golden = port_container.Container.from_bytes(
            _read(GOLDEN_DIR, "power_v2.fptc")
        )
        if fault == "flip-header":
            assert port.num_windows != -(-port.signal_length // port.n)
        else:
            assert port.plan_key != golden.plan_key
        return
    assert ref_err.fault in EXPECTED_FAULT[fault]
    with pytest.raises(port_container.ContainerFormatError) as got:
        port_container.Container.from_bytes(blob, index=7)
    assert isinstance(got.value, ValueError)
    assert got.value.fault == ref_err.fault
    assert got.value.offset == ref_err.offset
    assert got.value.index == 7
    assert str(got.value) == str(ref_err)


def _golden_hist(domain_id):
    """The histogram ``_synth.golden_tables`` builds its codebook from (the
    same seeded draws, in the same order)."""
    e = REF_DOMAIN_DEFAULTS[dict((i, k) for k, i in GOLDEN_DOMAINS)[
        domain_id
    ]].e
    rng = np.random.default_rng(1000 + domain_id)
    rng.standard_normal((256, e))
    return rng.integers(1, 1000, 256).astype(np.int64)


@pytest.mark.parametrize("domain_key,dom_id", GOLDEN_DOMAINS)
def test_codebook_matches_reference(domain_key, dom_id):
    """The codebook of every golden domain's histogram equals the
    reference's, table for table — and rebuilding it from its code lengths
    alone gives the same tables."""
    hist = _golden_hist(dom_id)
    l_max = REF_DOMAIN_DEFAULTS[domain_key].l_max
    ref = ref_huffman.build_codebook(hist, l_max=l_max)
    port = port_huffman.build_codebook(hist, l_max=l_max)
    again = port_huffman.codebook_from_lengths(ref.lengths, l_max)
    for name in _BOOK_ARRAYS:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
        np.testing.assert_array_equal(getattr(again, name),
                                      getattr(ref, name))
        assert getattr(port, name).dtype == getattr(ref, name).dtype, name
    assert port.l_max == ref.l_max


@pytest.mark.parametrize("l_max", [1, 8, 12, 16])
def test_codebook_edge_histograms(l_max):
    """Single-symbol, uniform and steeply skewed histograms."""
    rng = np.random.default_rng(l_max)
    single = np.zeros(256, np.int64)
    single[128] = 5
    hists = [single]
    if l_max >= 8:
        hists += [
            np.full(256, 10, np.int64),
            (2.0 ** rng.uniform(0, 20, 256)).astype(np.int64) + 1,
        ]
    for hist in hists:
        ref = ref_huffman.build_codebook(hist, l_max=l_max)
        port = port_huffman.build_codebook(hist, l_max=l_max)
        for name in _BOOK_ARRAYS:
            np.testing.assert_array_equal(
                getattr(port, name), getattr(ref, name)
            )
        assert port_huffman.kraft_sum(port.lengths) == pytest.approx(
            ref_huffman.kraft_sum(ref.lengths)
        )


def test_codebook_from_lengths_validates():
    with pytest.raises(ValueError, match="lengths"):
        port_huffman.codebook_from_lengths(np.zeros(255, np.int32), 8)
    with pytest.raises(ValueError, match="l_max"):
        port_huffman.codebook_from_lengths(np.full(256, 9, np.int32), 8)
