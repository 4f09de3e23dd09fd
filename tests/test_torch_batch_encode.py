"""The port's batched encode engine — the encode slice as a whole — held
against the JAX package.

Signals are made from seeds with numpy; tables cross through
``tables_from_arrays``.  ``BatchEncoder(device="cpu")`` runs every kernel
wrapper's plain version, and its containers must equal the reference's XLA
engine arm ``repro.serving.BatchEncoder(use_kernels=False)`` byte for byte,
in chunked and in exact mode; ``encode_fixed`` levels must be equal.  The
same engine on the card: ``tests/test_torch_gpu.py``."""
import dataclasses

import pytest

jnp = pytest.importorskip("jax.numpy")  # the reference; absent on the card

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _synth import golden_tables  # noqa: E402
from repro.core import codec as ref_codec
from repro.core.calibration import calibrate as ref_calibrate
from repro.core.config import DOMAIN_DEFAULTS
from repro.core.huffman import build_codebook as ref_build_codebook
from repro.data import make_signal
from repro.serving import BatchEncoder as RefBatchEncoder
from repro_torch.core import codec
from repro_torch.core.calibration import tables_from_arrays
from repro_torch.core.container import Container
from repro_torch.kernels import ops
from repro_torch.serving import (
    DEFAULT_CHUNK_SIZE,
    BatchDecoder,
    BatchEncoder,
    default_encoder,
)

# one signal length per domain (the strip too), so the reference compiles
# each domain's shapes once; the lengths differ across domains and end in
# partial windows
ARCHIVAL = [
    ("biomedical", "mitbih", 3001),
    ("seismic", "seismic", 2049),
    ("power", "load_power", 1500),
    ("meteorological", "temperature", 777),
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


@pytest.fixture(scope="module")
def batch():
    """Mixed domains x {v2, v3 delta, v3 linear2}: (signals, domain ids,
    reference tables, port tables).  Each domain is calibrated once; its v3
    tables overlay the coding on the v2 tables, as the golden v3 tables
    do."""
    ref_tables, sigs, doms = {}, [], []
    for d, (dom, ds, length) in enumerate(ARCHIVAL):
        v2 = ref_calibrate(make_signal(ds, length, seed=d),
                           DOMAIN_DEFAULTS[dom], domain_id=d)
        pair = [make_signal(ds, length, seed=200 + 4 * d + i)
                for i in range(2)]
        for j, coding in enumerate(CODINGS):
            did = 4 * j + d
            ref_tables[did] = dataclasses.replace(
                v2, config=v2.config.replace(**coding), domain_id=did)
            sigs += pair
            doms += [did, did]
    # interleave the plan keys
    order = list(range(0, len(sigs), 2)) + list(range(1, len(sigs), 2))
    sigs = [sigs[i] for i in order]
    doms = [doms[i] for i in order]
    port_tables = {k: carry(t) for k, t in ref_tables.items()}
    return sigs, doms, ref_tables, port_tables


@pytest.mark.parametrize("chunk_size", [DEFAULT_CHUNK_SIZE, None],
                         ids=["chunked", "exact"])
def test_mixed_batch_bytes_match_reference_engine(batch, chunk_size):
    sigs, doms, ref_tables, port_tables = batch
    ref = RefBatchEncoder(chunk_size=chunk_size, use_kernels=False,
                          devices=None).encode_to_host(
        sigs, ref_tables, domain_ids=doms)
    enc = BatchEncoder(chunk_size=chunk_size, device="cpu")
    before = dict(ops.LAUNCHES)
    got = enc.encode(sigs, port_tables, domain_ids=doms).to_host()
    assert ops.LAUNCHES == before  # the CPU runs the plain versions only
    assert len(got) == len(ref) == len(sigs)
    for g, r, s, d in zip(got, ref, sigs, doms):
        assert isinstance(g, Container)
        assert g.to_bytes() == r.to_bytes()
        assert g.signal_length == s.shape[0] and g.domain_id == d
    assert enc.stats.dispatches == len(ARCHIVAL) * len(CODINGS)
    if chunk_size is None:  # exact mode: the host encoder's bytes too
        for g, s, d in zip(got, sigs, doms):
            assert g.to_bytes() == codec.encode(s, port_tables[d]).to_bytes()
    # the containers decode like the host encoder's
    out = BatchDecoder(device="cpu").decode(got, port_tables).to_host()
    for o, s, d in zip(out, sigs, doms):
        want = codec.decode(codec.encode(s, port_tables[d]), port_tables[d])
        np.testing.assert_array_equal(o, want)


def test_encode_device_equals_host_encode(batch):
    sigs, doms, ref_tables, port_tables = batch
    for s, d in list(zip(sigs, doms))[:: len(ARCHIVAL) - 1]:
        got = codec.encode_device(s, port_tables[d], device="cpu")
        want = codec.encode(s, port_tables[d]).to_bytes()
        assert got.to_bytes() == want
        assert want == ref_codec.encode(s, ref_tables[d]).to_bytes()
    assert default_encoder(device="cpu").chunk_size is None
    assert default_encoder(device="cpu") is default_encoder(None, "cpu")


def test_encode_fixed_levels_match_reference():
    ref_tables = golden_tables("kv", 5)
    cfg = ref_tables.config
    rng = np.random.default_rng(7)
    x = (np.cumsum(rng.standard_normal((2, 3, 4 * cfg.n)), axis=-1)
         * 0.3).astype(np.float32)
    ref = np.asarray(RefBatchEncoder(use_kernels=False, devices=None)
                     .encode_fixed(jnp.asarray(x), ref_tables))
    enc = BatchEncoder(device="cpu")
    got = enc.encode_fixed(torch.from_numpy(x), carry(ref_tables))
    assert got.dtype == torch.uint8 and got.shape == (2, 3, 4, cfg.e)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert enc.stats.dispatches == 1
    with pytest.raises(ValueError, match="multiple of the window size"):
        enc.encode_fixed(torch.zeros(2, cfg.n + 1), carry(ref_tables))


def test_drain_once_and_submit_flush(batch):
    sigs, doms, _, port_tables = batch
    enc = BatchEncoder(device="cpu", chunk_size=256, pipeline=False)
    first = enc.encode(sigs[:5], port_tables, domain_ids=doms[:5])
    assert len(first) == 5 and enc.stats.dispatches == 5
    want = first.to_host()
    with pytest.raises(RuntimeError, match="already drained"):
        first.to_host()
    for i, (s, d) in enumerate(zip(sigs[:5], doms[:5])):
        assert enc.submit(s, d) == i
    assert enc.pending == 5
    got = enc.flush(port_tables).to_host()
    assert enc.pending == 0
    assert [c.to_bytes() for c in got] == [c.to_bytes() for c in want]
    assert [c.to_bytes() for c in enc.encode_to_host(
        sigs[:5], port_tables, domain_ids=doms[:5])] == \
        [c.to_bytes() for c in want]
    assert enc.flush(port_tables).to_host() == []
    with pytest.raises(ValueError, match="domain_ids is required"):
        enc.encode(sigs[:1], port_tables)
    with pytest.raises(KeyError, match="domain_id"):
        enc.encode(sigs[:1], port_tables, domain_ids=[99])


@pytest.mark.parametrize("chunk_size", [3, None], ids=["chunk3", "exact"])
def test_degenerate_signals_match_reference(chunk_size):
    """Empty, one-sample and sub-window signals, and an all-zero one whose
    v3 grid is all zero planes, in one batch beside an ordinary signal."""
    v2 = golden_tables("meteorological", 3)
    sigs = [np.zeros(0, np.float32), np.ones(1, np.float32),
            make_signal("temperature", 33, seed=2), np.zeros(64, np.float32)]
    for coding in CODINGS[::2]:
        ref_tables = dataclasses.replace(
            v2, config=v2.config.replace(**coding))
        ref = RefBatchEncoder(chunk_size=chunk_size, use_kernels=False,
                              devices=None).encode_to_host(sigs, ref_tables)
        got = BatchEncoder(chunk_size=chunk_size, device="cpu").encode_to_host(
            sigs, carry(ref_tables))
        assert [g.to_bytes() for g in got] == [r.to_bytes() for r in ref]
        assert got[0].num_words == 0 and got[0].signal_length == 0


def test_histogram_gap_is_batch_fatal_at_drain():
    """A book that covers only the zero bin: a signal that quantizes off
    zero fails the drain (and a retry fails the same way); an all-zero
    signal still encodes, as in the reference."""
    hist = np.zeros(256, np.int64)
    hist[128] = 100
    base = golden_tables("meteorological", 3)
    ref_tables = dataclasses.replace(
        base, book=ref_build_codebook(hist, l_max=base.config.l_max))
    tables = carry(ref_tables)
    sig = (np.sin(np.linspace(0, 30, 512)) * 5).astype(np.float32)
    enc = BatchEncoder(device="cpu")
    assert enc.plan_for(tables).has_gaps
    bad = enc.encode([sig], tables)
    for _ in range(2):
        with pytest.raises(ValueError, match="histogram gap"):
            bad.to_host()
    with pytest.raises(ValueError, match="histogram gap"):
        RefBatchEncoder(use_kernels=False, devices=None).encode(
            [sig], ref_tables).to_host()
    zeros = np.zeros(512, np.float32)
    got = enc.encode([zeros], tables).to_host()[0]
    ref = RefBatchEncoder(use_kernels=False, devices=None).encode(
        [zeros], ref_tables).to_host()[0]
    assert got.to_bytes() == ref.to_bytes()


def test_no_card_means_an_error(monkeypatch):
    """The entry points run on the card unless the caller asks for the
    CPU; with no card they raise rather than run on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchEncoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_encoder()
    with pytest.raises(ValueError, match="positive"):
        BatchEncoder(device="cpu", chunk_size=0)


def test_parts_members_and_block_until_ready_match_reference(batch):
    """``EncodedBucketParts.num_chunks`` / ``.words_per_signal()`` and
    ``EncodedBatch.block_until_ready`` against the reference engine's on
    the same signals."""
    sigs, doms, ref_tables, port_tables = batch
    ref = RefBatchEncoder(chunk_size=DEFAULT_CHUNK_SIZE, use_kernels=False,
                          devices=None).encode(sigs, ref_tables,
                                               domain_ids=doms)
    got = BatchEncoder(chunk_size=DEFAULT_CHUNK_SIZE, device="cpu").encode(
        sigs, port_tables, domain_ids=doms)
    assert ref.block_until_ready() is ref
    assert got.block_until_ready() is got
    ref_parts, parts = ref.device_parts(), got.device_parts()
    assert len(parts) == len(ref_parts) == len(ARCHIVAL) * len(CODINGS)
    for g, r in zip(parts, ref_parts):
        assert g.num_chunks == r.num_chunks
        assert g.chunk_size == r.chunk_size
        wps = g.words_per_signal()
        assert wps.dtype == torch.int32
        np.testing.assert_array_equal(wps.numpy(),
                                      np.asarray(r.words_per_signal()))
    assert max(p.num_chunks for p in parts) > 1
