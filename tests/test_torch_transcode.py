"""The port's transcoder — the transcode slice as a whole — held against the
JAX package and against its own engines.

Tables are calibrated by the JAX package and cross through
``tables_from_arrays``; source containers are encoded by the JAX package
and cross as bytes.  ``Transcoder(device="cpu")`` runs every kernel
wrapper's plain version.  Each case of ``tests/test_transcode.py`` is
mirrored, and each holds two things:

  * the transcode contract, exactly: the port's transcode equals the port's
    own round trip (``BatchDecoder.decode(...).to_host()`` then
    ``BatchEncoder.encode(...)``) byte for byte;
  * the reference: the port's containers equal the reference's
    ``Transcoder(use_kernels=False)`` byte for byte wherever the two
    packages re-quantize the decoded signal to the same levels.  The two
    decode to floats that differ in the last bits (the dequant LUT's
    ``expm1``/``log1p`` and the product orders of torch and XLA on the
    CPU), and the re-encode sums its DCT in another order than XLA's CPU
    dot, so a coefficient within that noise of a quantizer cell boundary
    lands on another level.  Most such cells are in the deadzone class
    {127, 128, 129}: level 128 reconstructs to a zero coefficient whose
    re-encode is zero but for noise (its sign picks 127 or 129 in a mu-law
    band), and 127/129 reconstruct exactly onto the linear deadzone's edge
    (``tests/_synth.py::golden_signal`` steers its frozen signals clear of
    them for that reason) — no encoder re-quantizes them stably.  So where
    the level grids differ: a cell of the deadzone class in both packages
    may differ by up to 2 levels; any other cell by 1 level, in at most
    ``FLIP_SHARE`` of the batch's cells; and the container headers agree.

The same transcoder on the card: ``tests/test_torch_gpu.py``."""
import dataclasses

import pytest

jnp = pytest.importorskip("jax.numpy")  # the reference; absent on the card

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _synth import (  # noqa: E402
    gap_tables,
    single_symbol_tables,
    uniform_code_container,
)
from repro.core import DOMAIN_DEFAULTS
from repro.core import calibrate as ref_calibrate
from repro.core import encode as ref_encode
from repro.core import transcode as ref_codec_transcode
from repro.data import make_signal
from repro.serving import BatchEncoder as RefBatchEncoder
from repro.serving import Transcoder as RefTranscoder
from repro_torch.core import codec, quantize, symlen
from repro_torch.core.calibration import tables_from_arrays
from repro_torch.core.container import Container
from repro_torch.kernels import ops
from repro_torch.serving import (
    DEFAULT_CHUNK_SIZE,
    BatchDecoder,
    BatchEncoder,
    EncodedBatch,
    Transcoder,
    default_transcoder,
)

# (domain_id, dataset, DOMAIN_DEFAULTS key), as the reference's suite
DOMAINS = [
    (0, "load_power", "power"),
    (1, "temperature", "meteorological"),
    (2, "mitbih", "biomedical"),
]
LENGTHS = [2048, 1533, 700]  # mixed window buckets, one sub-window tail
# differing levels outside the deadzone class allowed per cell of a batch,
# against the reference (each within 1 level; see the module docstring)
FLIP_SHARE = 0.005
DEADZONE = (127, 128, 129)


def carry(ref_tables):
    q = ref_tables.quant
    return tables_from_arrays(
        dataclasses.asdict(ref_tables.config), ref_tables.domain_id,
        zone=np.asarray(q.zone), scale=np.asarray(q.scale), mu=float(q.mu),
        alpha1=float(q.alpha1), lengths=np.asarray(ref_tables.book.lengths),
    )


def port(containers):
    return [Container.from_bytes(c.to_bytes()) for c in containers]


def carry_all(tables):
    if isinstance(tables, dict):
        return {k: carry(t) for k, t in tables.items()}
    return carry(tables)


@pytest.fixture(scope="module")
def tables():
    """(reference tables, port tables) per domain id."""
    ref = {
        d: ref_calibrate(make_signal(ds, 65536, seed=7 + d),
                         DOMAIN_DEFAULTS[key], domain_id=d)
        for d, ds, key in DOMAINS
    }
    return ref, {d: carry(t) for d, t in ref.items()}


def src_containers(dom, ref_tables):
    ds = next(ds for d, ds, _ in DOMAINS if d == dom)
    sigs = [make_signal(ds, n, seed=100 * dom + i)
            for i, n in enumerate(LENGTHS)]
    return [ref_encode(s, ref_tables[dom]) for s in sigs]


def ref_transcode(source, src, dst, *, chunk_size=DEFAULT_CHUNK_SIZE,
                  dst_domain_ids=None):
    return RefTranscoder(chunk_size=chunk_size, use_kernels=False,
                         devices=None).transcode(
        source, src, dst, dst_domain_ids=dst_domain_ids).to_host()


def port_roundtrip(containers, src, dst, *, chunk_size=DEFAULT_CHUNK_SIZE,
                   dst_domain_ids=None):
    """The host round trip the port's transcoder must equal byte for byte:
    decode to host signals, then re-encode them (the same chunk size)."""
    sigs = BatchDecoder(device="cpu").decode(containers, src).to_host()
    return BatchEncoder(chunk_size=chunk_size, device="cpu").encode(
        sigs, dst, domain_ids=dst_domain_ids).to_host()


def levels(c, tab):
    """A container's quantized levels [num_windows, e] (v3: un-predicted),
    by the port's host decoder."""
    syms = symlen.unpack_symlen_np(
        symlen.PackedStream(c.words, c.symlen.astype(np.int32),
                            c.num_symbols), tab.book)
    nw, e = c.num_windows, c.e
    if c.coding == (0, 0, False):
        return syms.reshape(nw, e).astype(np.int64)
    idx, seg = symlen.v3_expand_index([(nw, c.zrow, c.zcol)], e)
    if syms.size == 0:
        grid = torch.full((nw, e), 128, dtype=torch.uint8)
    else:
        grid = quantize.expand_coded_stream(
            torch.from_numpy(syms), torch.from_numpy(idx)).reshape(nw, e)
    pred, bands, _ = c.coding
    return quantize.unpredict_levels(
        grid, torch.from_numpy(seg), pred, bands).numpy().astype(np.int64)


def assert_identical(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert isinstance(a, Container)
        assert a.to_bytes() == b.to_bytes()


def assert_matches_reference(got, ref, dst, dst_ids=None):
    """Byte-equal wherever the level grids agree; otherwise the flip rule
    (module docstring).  Returns the differing cells outside and inside
    the deadzone class."""
    assert len(got) == len(ref)
    flips = deadzone = cells = 0
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.plan_key == r.plan_key
        assert (g.signal_length, g.num_windows) == (r.signal_length,
                                                    r.num_windows)
        tab = dst if not isinstance(dst, dict) else dst[
            g.domain_id if dst_ids is None else dst_ids[i]]
        lg, lr = levels(g, tab), levels(r, tab)
        d = np.abs(lg - lr)
        cells += d.size
        if not d.any():
            assert g.to_bytes() == r.to_bytes(), f"signal {i}"
            continue
        dz = np.isin(lg, DEADZONE) & np.isin(lr, DEADZONE)
        assert d[dz].max(initial=0) <= 2, f"signal {i}"
        assert d[~dz].max(initial=0) <= 1, f"signal {i}: {d[~dz].max()}"
        flips += int((d[~dz] > 0).sum())
        deadzone += int((d[dz] > 0).sum())
    assert flips <= FLIP_SHARE * max(cells, 1), (flips, cells)
    return flips, deadzone


def check(containers, ref_src, ref_dst, *, chunk_size=DEFAULT_CHUNK_SIZE,
          dst_domain_ids=None, tc=None):
    """Transcode the (reference) containers with the port and hold the
    result against the port's round trip and the reference."""
    src, dst = carry_all(ref_src), carry_all(ref_dst)
    pc = port(containers)
    tc = tc or Transcoder(chunk_size=chunk_size, device="cpu")
    before = dict(ops.LAUNCHES)
    got = tc.transcode(pc, src, dst, dst_domain_ids=dst_domain_ids).to_host()
    assert ops.LAUNCHES == before  # the CPU runs the plain versions only
    ids = dst_domain_ids
    if ids is None and isinstance(dst, dict):  # the source domain ids
        ids = [c.domain_id for c in pc]
    assert_identical(got, port_roundtrip(pc, src, dst, chunk_size=chunk_size,
                                         dst_domain_ids=ids))
    ref = ref_transcode(containers, ref_src, ref_dst, chunk_size=chunk_size,
                        dst_domain_ids=dst_domain_ids)
    assert_matches_reference(got, ref, dst, dst_domain_ids)
    return got


@pytest.mark.parametrize("src_dom", [d for d, _, _ in DOMAINS])
@pytest.mark.parametrize("dst_dom", [d for d, _, _ in DOMAINS])
def test_conformance_every_domain_pair(tables, src_dom, dst_dom):
    ref, _ = tables
    check(src_containers(src_dom, ref), ref[src_dom], ref[dst_dom])


@pytest.mark.parametrize("chunk_size", [None, 64])
def test_conformance_explicit_chunk_sizes(tables, chunk_size):
    """Exact mode (None) and a chunk small enough to force multi-chunk
    re-packing."""
    ref, _ = tables
    check(src_containers(0, ref), ref[0], ref[2], chunk_size=chunk_size)


def test_mixed_domain_batch_straddling_bucket_boundaries(tables):
    """Per-group word counts exactly at and one past a power of two
    (255/256/257 words): padding words contribute no symbols through the
    whole pipeline."""
    ref, _ = tables
    c255, t255 = uniform_code_container(255, seed=255, domain_id=10)
    c256, t256 = uniform_code_container(256, seed=256, domain_id=11)
    c257, _ = uniform_code_container(257, seed=257, domain_id=10)
    check([c255, c256, c257], {10: t255, 11: t256}, ref[1])


def test_degenerate_inputs(tables):
    """An empty signal, one shorter than a window, and a single-symbol
    alphabet (1-bit codes, 64 symbols per word)."""
    ref, port_tables = tables
    power = ref[0]
    n = power.config.n
    containers = [ref_encode(np.empty(0, np.float32), power),
                  ref_encode(make_signal("load_power", n // 4, seed=3),
                             power)]
    got = check(containers, power, ref[1])
    assert got[0].num_windows == 0 and got[0].num_words == 0

    ss = single_symbol_tables(domain_id=5)
    c = ref_encode(np.zeros(100, np.float32), ss)
    got = check([c], ss, power)
    rec = codec.decode(got[0], port_tables[0])
    np.testing.assert_allclose(rec, np.zeros(100, np.float32), atol=1e-5)


def _encoded_pair(sigs, ref_src, chunk_size, domain_ids=None):
    """The same signals encoded by both packages' engines."""
    src = carry_all(ref_src)
    ref_batch = RefBatchEncoder(chunk_size=chunk_size, use_kernels=False,
                                devices=None).encode(
        sigs, ref_src, domain_ids=domain_ids)
    batch = BatchEncoder(chunk_size=chunk_size, device="cpu").encode(
        sigs, src, domain_ids=domain_ids)
    return ref_batch, batch, src


def _check_encoded_source(sigs, ref_src, ref_dst, chunk_size,
                          domain_ids=None):
    ref_batch, batch, src = _encoded_pair(sigs, ref_src, chunk_size,
                                          domain_ids)
    dst = carry_all(ref_dst)
    # the contract: equal to draining an identically encoded batch and
    # round-tripping its containers
    drained = BatchEncoder(chunk_size=chunk_size, device="cpu").encode(
        sigs, src, domain_ids=domain_ids).to_host()
    tc = Transcoder(device="cpu")
    got = tc.transcode(batch, src, dst).to_host()
    assert tc.stats.stitches >= 1
    assert_identical(got, port_roundtrip(drained, src, dst))
    assert_identical(got, Transcoder(device="cpu").transcode_to_host(
        drained, src, dst))
    ref = RefTranscoder(use_kernels=False, devices=None).transcode(
        ref_batch, ref_src, ref_dst).to_host()
    assert_matches_reference(got, ref, dst)
    # the source batch was consumed by the stitch, in both packages
    with pytest.raises(RuntimeError, match="donated"):
        batch.to_host()
    with pytest.raises(RuntimeError, match="donated"):
        ref_batch.to_host()
    with pytest.raises(RuntimeError, match="donated"):
        batch.device_parts()
    return tc


def test_encoded_batch_source_multi_chunk(tables):
    """Chunk parts of many chunks per signal feed the decoder through the
    device-side stitch."""
    ref, _ = tables
    sigs = [make_signal("load_power", n, seed=40 + i)
            for i, n in enumerate([4096, 3001, 500])]
    _check_encoded_source(sigs, ref[0], ref[2], 32)


def test_encoded_batch_source_mixed_domains(tables):
    """Several encode buckets per plan key merge into one decode group per
    (domain, config)."""
    ref, _ = tables
    sigs, doms = [], []
    for i, n in enumerate([2048, 1000, 3000, 257 * 8]):
        dom = i % 2
        sigs.append(make_signal("load_power" if dom == 0 else "temperature",
                                n, seed=50 + i))
        doms.append(dom)
    _check_encoded_source(sigs, {0: ref[0], 1: ref[1]}, ref[1], 128,
                          domain_ids=doms)


def test_exact_capacity_same_bytes_one_sync(tables):
    ref, port_tables = tables
    sigs = [make_signal("load_power", n, seed=60 + i)
            for i, n in enumerate([4096, 700])]
    src, dst = port_tables[0], port_tables[1]
    enc = BatchEncoder(chunk_size=32, device="cpu")
    want = Transcoder(device="cpu").transcode(
        enc.encode(sigs, src), src, dst).to_host()
    tc = Transcoder(device="cpu", exact_capacity=True)
    got = tc.transcode(enc.encode(sigs, src), src, dst).to_host()
    assert tc.stats.capacity_syncs == 1
    assert_identical(got, want)


def test_v3_encoded_source_is_refused_like_the_reference(tables):
    """A v3-coded EncodedBatch source needs its zero-plane bitmaps on the
    host: both packages refuse it with the same words, and the source
    stays drainable."""
    ref, _ = tables
    v3 = dataclasses.replace(ref[0], config=ref[0].config.replace(
        predictor="delta", predict_bands=2, zero_planes=True))
    sigs = [make_signal("load_power", 1024, seed=70)]
    ref_batch, batch, src = _encoded_pair(sigs, v3, DEFAULT_CHUNK_SIZE)
    with pytest.raises(NotImplementedError) as want:
        RefTranscoder(use_kernels=False, devices=None).transcode(
            ref_batch, v3, ref[1])
    with pytest.raises(NotImplementedError) as got:
        Transcoder(device="cpu").transcode(batch, src, carry(ref[1]))
    assert str(got.value) == str(want.value)
    assert len(batch.to_host()) == 1


def test_v2_to_v3_upgrade_from_encoded_source(tables):
    """v3 on the TARGET is fine from an EncodedBatch source."""
    ref, port_tables = tables
    v3 = dataclasses.replace(ref[1], config=ref[1].config.replace(
        predictor="linear2", predict_bands=2, zero_planes=True))
    sigs = [make_signal("load_power", n, seed=80 + i)
            for i, n in enumerate([3000, 64])]
    _check_encoded_source(sigs, ref[0], v3, 256)


def test_dst_domain_routing(tables):
    """A mapping of target tables: the default routing (source domain ids)
    and explicit cross-routing."""
    ref, _ = tables
    containers = src_containers(0, ref) + src_containers(1, ref)
    both = {0: ref[0], 1: ref[1]}
    got = check(containers, both, both)
    assert [c.domain_id for c in got] == [0] * 3 + [1] * 3
    swap = [1] * 3 + [0] * 3
    got = check(containers, both, both, dst_domain_ids=swap)
    assert [c.domain_id for c in got] == swap


def test_codec_transcode_batch_of_one(tables):
    """``core.codec.transcode`` is the exact-mode container-of-one wrapper:
    it equals the host encoder on the port-decoded signal, and the
    reference's ``codec.transcode`` by the flip rule."""
    ref, port_tables = tables
    c = src_containers(0, ref)[0]
    src, dst = port_tables[0], port_tables[1]
    pc = port([c])[0]
    got = codec.transcode(pc, src, dst, device="cpu")
    sig = BatchDecoder(device="cpu").decode([pc], src).to_host()[0]
    assert got.to_bytes() == codec.encode(sig, dst).to_bytes()
    assert_identical([got], port_roundtrip([pc], src, dst, chunk_size=None))
    assert_matches_reference([got], [ref_codec_transcode(c, ref[0], ref[1])],
                             dst)
    assert default_transcoder(device="cpu").encoder.chunk_size is None


def test_transcoded_containers_decode_everywhere(tables):
    """Transcoded containers are ordinary containers: the host and batch
    decoders read them alike."""
    ref, port_tables = tables
    src, dst = port_tables[1], port_tables[0]
    pc = port(src_containers(1, ref))
    got = Transcoder(device="cpu").transcode_to_host(pc, src, dst)
    sigs = BatchDecoder(device="cpu").decode(pc, src).to_host()
    outs = BatchDecoder(device="cpu").decode(got, dst).to_host()
    for c, sig, out in zip(got, sigs, outs):
        host_rec = codec.decode(c, dst)
        np.testing.assert_array_equal(
            host_rec, codec.decode(codec.encode(sig, dst), dst))
        np.testing.assert_allclose(out, host_rec, atol=1e-4)


def test_empty_batch(tables):
    _, port_tables = tables
    out = Transcoder(device="cpu").transcode([], port_tables[0],
                                             port_tables[1])
    assert isinstance(out, EncodedBatch)
    assert len(out) == 0 and out.to_host() == []


def test_failed_transcode_leaves_source_drainable(tables):
    """A transcode that dies on bad routing does not consume its source."""
    _, port_tables = tables
    power = port_tables[0]
    batch = BatchEncoder(device="cpu").encode(
        [np.cumsum(np.ones(512, np.float32))], power)
    with pytest.raises(KeyError, match="domain_id=0"):
        # the dst mapping has no entry for the defaulted dst domain id (0)
        Transcoder(device="cpu").transcode(batch, power, {5: port_tables[1]})
    assert len(batch.to_host()) == 1  # still drainable


def test_chained_transcode_propagates_gap_flags(tables):
    """A histogram-gap flag survives any number of device-resident hops:
    the final drain still fails, in both packages."""
    ref, port_tables = tables
    ref_bad = gap_tables(domain_id=7)
    bad = carry(ref_bad)
    sig = (np.sin(np.linspace(0, 30, 512)) * 5).astype(np.float32)
    once = Transcoder(device="cpu").transcode(
        BatchEncoder(device="cpu").encode([sig], bad), bad, port_tables[0])
    twice = Transcoder(device="cpu").transcode(once, port_tables[0],
                                               port_tables[1])
    for _ in range(2):  # a failed drain leaves the batch drainable
        with pytest.raises(ValueError, match="histogram gap"):
            twice.to_host()
    ref_once = RefTranscoder(use_kernels=False, devices=None).transcode(
        RefBatchEncoder(use_kernels=False, devices=None).encode([sig],
                                                                ref_bad),
        ref_bad, ref[0])
    with pytest.raises(ValueError, match="histogram gap"):
        RefTranscoder(use_kernels=False, devices=None).transcode(
            ref_once, ref[0], ref[1]).to_host()


def test_plan_pairing_cache(tables):
    """TranscodePlan pairs the decode and encode plans under one key, is
    reused across batches, and shares the engines' own plans."""
    ref, port_tables = tables
    src, dst = port_tables[0], port_tables[1]
    tc = Transcoder(device="cpu")
    plan = tc.plan_for(src, dst)
    assert plan.src_key == (0, src.config.n, src.config.e, src.config.l_max,
                            src.config.coding)
    assert plan.dst_key == (1, dst.config.n, dst.config.e, dst.config.l_max,
                            dst.config.coding)
    assert plan.decode.n == src.config.n and plan.encode.n == dst.config.n
    pc = port(src_containers(0, ref))
    tc.transcode(pc, src, dst).to_host()
    misses = tc._plans.misses
    tc.transcode(pc, src, dst).to_host()
    assert tc._plans.misses == misses  # pure cache hits
    assert tc.stats.batches == 2 and tc.stats.signals == 2 * len(pc)
    assert plan.decode is tc.decoder.plan_for(pc[0], src)
    assert plan.encode is tc.encoder.plan_for(dst)
    assert tc.plan_for(src, port_tables[2]) is not plan  # another pairing


def test_submit_flush_routes_like_transcode(tables):
    ref, port_tables = tables
    pc = port(src_containers(0, ref) + src_containers(1, ref))
    both = {0: port_tables[0], 1: port_tables[1]}
    tc = Transcoder(device="cpu", pipeline=False)
    routes = [1, None, 2, None, 0, None]
    for i, (c, d) in enumerate(zip(pc, routes)):
        assert tc.submit(c, d) == i
    assert tc.pending == len(pc)
    got = tc.flush(both, port_tables)
    assert tc.pending == 0
    dst_ids = [1, 0, 2, 1, 0, 1]  # None keeps the source domain id
    want = Transcoder(device="cpu").transcode_to_host(
        pc, both, port_tables, dst_domain_ids=dst_ids)
    assert_identical(got.to_host(), want)
    assert tc.flush(both, port_tables).to_host() == []


def test_flat_gather_range_guard(monkeypatch, tables):
    """The reference's int32 guard on the flat gather range: a batch whose
    decoded windows (plus the widest bucket's pad) pass it is refused
    before anything is encoded, and its EncodedBatch source stays
    drainable."""
    from repro_torch.serving import transcode as transcode_mod

    ref, port_tables = tables
    src, dst = port_tables[0], port_tables[1]
    pc = port(src_containers(0, ref))
    monkeypatch.setattr(transcode_mod, "_I32_MAX", 4096)
    with pytest.raises(ValueError, match="int32 gather range"):
        Transcoder(device="cpu").transcode(pc, src, dst)
    batch = BatchEncoder(device="cpu").encode([np.ones(3000, np.float32)],
                                              src)
    with pytest.raises(ValueError, match="int32 gather range"):
        Transcoder(device="cpu").transcode(batch, src, dst)
    assert len(batch.to_host()) == 1


def test_engines_must_agree():
    with pytest.raises(ValueError, match="bucket policy"):
        Transcoder(decoder=BatchDecoder(device="cpu", policy="half-octave"),
                   encoder=BatchEncoder(device="cpu"))


def test_no_card_means_an_error(monkeypatch, tables):
    """The transcoder runs on the card unless asked for the CPU; with no
    card it raises rather than run on the host."""
    _, port_tables = tables
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transcoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_transcoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codec.transcode(Container.from_bytes(
            ref_encode(np.zeros(64, np.float32), tables[0][0]).to_bytes()),
            port_tables[0], port_tables[1])
