"""The port's kernel modules held against the JAX package.

On the CPU every wrapper runs its plain PyTorch version, which is held
against the reference's XLA arm — never against the reference's Pallas
decode arms, which cannot run on this JAX (ROADMAP queue 3, R1):

  * K1 (``huffman_decode``): symbols exactly equal to
    ``repro.core.symlen.unpack_symlen`` and ``unpack_symlen_np``;
  * K2 (``decode_fused``): levels exactly equal, floats within
    ``max|d| <= 1e-5 * max|ref|`` of ``_decode_bucket_math(use_kernels=
    False)``; its v3 stage alone exactly equal to ``expand_coded_stream``
    + ``unpredict_levels`` on the adversarial segment layouts of
    ``tests/_v3_layouts.py``;
  * K3 (``idct_dequant``): within ``1e-5 * max|ref|`` of
    ``kernels/ref.py::idct_dequant_ref`` and of the Pallas kernel in
    interpret mode;
  * K5 (``dct_quant``): levels exactly equal to the Pallas kernel's
    ``exact=True`` arm in interpret mode;
  * K4 (``encode_fused``): every output (words, sidecars, word counts, gap
    flags, v3 counts and masks) exactly equal to the Pallas kernel in
    interpret mode and to the reference's ``_encode_bucket_math``; its
    gather arm (``encode_levels_gather``, the transcoder's) exactly equal
    to the reference's ``_encode_bucket_gather_math``, and the gather
    itself to ``_gather_rows_math``;
  * K6 (``huffman_decode_tile``): the whole slot-major tile — slots past a
    word's symlen and padding words included — exactly equal to the
    reference's Pallas tile kernel in interpret mode (the one Pallas decode
    arm this JAX still runs), and compacted, to ``unpack_symlen``.

The CUDA kernels against these plain versions, on the card:
``tests/test_torch_gpu.py``.
"""
import dataclasses
import functools

import pytest

jnp = pytest.importorskip("jax.numpy")  # the reference; absent on the card

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _synth import golden_tables  # noqa: E402
from repro.core import huffman as ref_huffman
from repro.core import symlen as ref_symlen
from repro.core.calibration import calibrate as ref_calibrate
from repro.core.codec import encode as ref_encode
from repro.core.config import DOMAIN_DEFAULTS
from repro.core.quantize import (
    expand_coded_stream as ref_expand,
    quant_grid as ref_quant_grid,
    unpredict_levels as ref_unpredict,
)
from repro.data import make_signal
from repro.kernels import ops as ref_ops
from repro.kernels.dct_quant import dct_quant as ref_pallas_dct_quant
from repro.kernels.encode_fused import encode_fused as ref_pallas_encode
from repro.kernels.idct_dequant import idct_dequant as ref_pallas_idct
from repro.kernels.ref import idct_dequant_ref
from repro.serving.batch_decode import _decode_bucket_math
from repro.kernels.huffman_decode import (
    huffman_decode_tile as ref_pallas_tile,
)
from repro.serving.batch_encode import (
    _encode_bucket_gather_math as ref_encode_bucket_gather_math,
)
from repro.serving.batch_encode import (
    _encode_bucket_math as ref_encode_bucket_math,
)
from repro.serving.batch_encode import _gather_rows_math as ref_gather_rows
from repro_torch.core import dct, quantize, symlen
from repro_torch.core.calibration import tables_from_arrays
from repro_torch.core.huffman import codebook_from_lengths
from repro_torch.kernels import dct_quant as dq
from repro_torch.kernels import decode_fused as df
from repro_torch.kernels import encode_fused as ef
from repro_torch.kernels import huffman_decode as hd
from repro_torch.kernels import idct_dequant as idq
from repro_torch.kernels import ops
from repro_torch.serving.batch_encode import (
    _encode_bucket_gather_math,
    _encode_bucket_math,
    _gather_rows_math,
)
from repro_torch.serving.engine import p2, symlen_bucket
from _v3_layouts import LAYOUTS, v3_stage_case

REL_TOL = 1e-5


def carry(ref_tables):
    q = ref_tables.quant
    return tables_from_arrays(
        dataclasses.asdict(ref_tables.config), ref_tables.domain_id,
        zone=np.asarray(q.zone), scale=np.asarray(q.scale), mu=float(q.mu),
        alpha1=float(q.alpha1), lengths=np.asarray(ref_tables.book.lengths),
    )


def assert_close(got, ref, rel=REL_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max(initial=0.0) <= rel * max(
        np.abs(ref).max(initial=0.0), 1e-30
    )


# ---------------------------------------------------------------------------
# K1: the SymLen decode.
# ---------------------------------------------------------------------------
def _k1_case(l_max, seed=0):
    """A skewed codebook (codes up to ``l_max`` bits), three packed streams
    concatenated, and zero padding words."""
    rng = np.random.default_rng(seed + l_max)
    hist = (2.0 ** rng.uniform(0, min(l_max, 20), 256)).astype(np.int64) + 1
    book = ref_huffman.build_codebook(hist, l_max=l_max)
    p = hist / hist.sum()
    streams = [
        ref_symlen.pack_symlen_np(
            rng.choice(256, size=n, p=p).astype(np.uint8), book
        )
        for n in (1000, 333, 4097)
    ]
    words = np.concatenate([s.words for s in streams])
    sl = np.concatenate([s.symlen for s in streams]).astype(np.int32)
    total = sum(s.num_symbols for s in streams)
    wp = p2(words.size) + 5
    words = np.concatenate([words, np.zeros(wp - words.size, np.uint64)])
    sl = np.concatenate([sl, np.zeros(wp - sl.size, np.int32)])
    return book, streams, words, sl, total


def carry_book(book):
    """The port's device tables for a reference codebook (via lengths)."""
    from repro_torch.core.calibration import DomainTables
    from repro_torch.core.config import CodecConfig
    from repro_torch.core.quantize import quant_table_from_arrays

    port_book = codebook_from_lengths(book.lengths, book.l_max)
    cfg = CodecConfig(n=8, e=8, b1=0, b2=8, l_max=book.l_max)
    quant = quant_table_from_arrays(np.zeros(8), np.ones(8), 50.0, 0.0)
    return DomainTables(config=cfg, quant=quant, book=port_book)


@pytest.mark.parametrize("l_max", [8, 12, 16])
def test_k1_plain_matches_reference(l_max):
    book, streams, words, sl, total = _k1_case(l_max)
    max_symlen = symlen_bucket(int(sl.max()))
    num_symbols = total + 37  # positions past the total read 0
    hi, lo = ref_symlen.words_to_u32(words)
    ref = np.asarray(ref_symlen.unpack_symlen(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(sl),
        jnp.asarray(book.limit_shifted[1:]),
        jnp.asarray(book.first_code_shifted),
        jnp.asarray(book.rank_offset),
        jnp.asarray(book.sorted_symbols.astype(np.int32)),
        l_max=l_max, max_symlen=max_symlen, num_symbols=num_symbols,
    ))
    host = np.concatenate([ref_symlen.unpack_symlen_np(s, book)
                           for s in streams])
    tables = carry_book(book).device_tables("cpu")
    before = dict(ops.LAUNCHES)
    got = hd.huffman_decode_dense(
        torch.from_numpy(words.view(np.int64)),
        torch.from_numpy(sl.astype(np.uint8)), tables,
        l_max=l_max, max_symlen=max_symlen, num_symbols=num_symbols,
    ).numpy()
    assert ops.LAUNCHES == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:total], host)
    assert not got[total:].any()
    # the port's own host decoder agrees too
    port_host = np.concatenate([
        symlen.unpack_symlen_np(
            symlen.PackedStream(s.words, s.symlen, s.num_symbols),
            codebook_from_lengths(book.lengths, l_max),
        )
        for s in streams
    ])
    np.testing.assert_array_equal(port_host, host)


def test_compact_padded_scatter_matches_reference():
    rng = np.random.default_rng(5)
    padded = rng.integers(0, 256, (40, 16)).astype(np.int32)
    sl = rng.integers(0, 17, 40).astype(np.int32)
    sl[-3:] = 0
    num = int(sl.sum()) - 4  # drops the last positions too
    ref = np.asarray(ref_symlen.compact_padded_scatter(
        jnp.asarray(padded), jnp.asarray(sl), num
    ))
    got = symlen.compact_padded_scatter(
        torch.from_numpy(padded), torch.from_numpy(sl), num
    ).numpy()
    np.testing.assert_array_equal(got, ref)


def test_pack_symlen_np_matches_reference():
    book = _k1_case(12, seed=3)[0]
    rng = np.random.default_rng(9)
    syms = rng.integers(0, 256, 5000).astype(np.uint8)
    ref = ref_symlen.pack_symlen_np(syms, book)
    got = symlen.pack_symlen_np(syms, codebook_from_lengths(book.lengths, 12))
    np.testing.assert_array_equal(got.words, ref.words)
    np.testing.assert_array_equal(got.symlen, ref.symlen)


# ---------------------------------------------------------------------------
# K2: the bucket decode.
# ---------------------------------------------------------------------------
CODINGS = [
    {},
    dict(predictor="delta", predict_bands=2, zero_planes=False),
    dict(predictor="delta", predict_bands=2, zero_planes=True),
    dict(predictor="linear2", predict_bands=3, zero_planes=False),
    dict(predictor="linear2", predict_bands=2, zero_planes=True),
]


K2_LENGTHS = (3000, 1500, 701)


@functools.lru_cache(maxsize=1)
def _k2_v2_tables():
    # a strip as long as the first signal: the reference's eager ops compile
    # once for both
    return ref_calibrate(make_signal("temperature", K2_LENGTHS[0], seed=1),
                         DOMAIN_DEFAULTS["meteorological"])


def _k2_case(coding):
    """A three-signal meteorological bucket under ``coding``, encoded by the
    JAX package, staged like the engines stage it.  The tables overlay the
    coding on one calibration (its Laplace-smoothed codebook covers every
    symbol), as the golden v3 tables do."""
    v2 = _k2_v2_tables()
    cfg = v2.config.replace(**coding)
    ref_tables = dataclasses.replace(v2, config=cfg)
    cs = [ref_encode(make_signal("temperature", n, seed=10 + i), ref_tables)
          for i, n in enumerate(K2_LENGTHS)]
    words = np.concatenate([c.words for c in cs])
    sl = np.concatenate([c.symlen for c in cs]).astype(np.int32)
    wp = p2(words.size)
    words = np.concatenate([words, np.zeros(wp - words.size, np.uint64)])
    sl = np.concatenate([sl, np.zeros(wp - sl.size, np.int32)])
    nwp = p2(sum(c.num_windows for c in cs))
    v3 = None
    if cfg.coding != (0, 0, False):
        v3 = ref_symlen.v3_expand_index(
            [(c.num_windows, c.zrow, c.zcol) for c in cs], cfg.e,
            total_windows=nwp,
        )
    kw = dict(l_max=cfg.l_max, max_symlen=symlen_bucket(int(sl.max())),
              num_windows=nwp, n=cfg.n, e=cfg.e, coding=cfg.coding)
    return ref_tables, words, sl, v3, kw


def _k2_port_inputs(ref_tables, words, sl, v3, kw, device="cpu"):
    t = carry(ref_tables)
    plan_lut = quantize.quant_grid(t.quant)[0].to(device)
    basis = dct.idct_basis(kw["n"], kw["e"], device=device)
    pv3 = None
    if v3 is not None:
        pv3 = tuple(torch.from_numpy(a).to(device) for a in v3)
    return (
        torch.from_numpy(words.view(np.int64)).to(device),
        torch.from_numpy(sl.astype(np.uint8)).to(device),
        t.device_tables(device), plan_lut, basis, pv3,
    )


@pytest.mark.parametrize("coding", CODINGS, ids=lambda c: "-".join(
    str(v) for v in c.values()) or "v2")
def test_k2_plain_matches_xla_arm(coding):
    ref_tables, words, sl, v3, kw = _k2_case(coding)
    dev = ref_tables.device_tables()
    hi, lo = ref_symlen.words_to_u32(words)
    lut = ref_quant_grid(ref_tables.quant)[0]
    basis = jnp.asarray(dct.idct_basis(kw["n"], kw["e"]).numpy())
    jv3 = None if v3 is None else tuple(jnp.asarray(a) for a in v3)
    ref = np.asarray(_decode_bucket_math(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(sl), dev, lut, basis,
        jv3, use_kernels=False, **kw,
    ))
    # the reference arm's levels, by the same functions it composes
    syms = ref_symlen.unpack_symlen(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(sl), dev.dec_limit,
        dev.dec_first, dev.dec_rank, dev.dec_syms, l_max=kw["l_max"],
        max_symlen=kw["max_symlen"], num_symbols=kw["num_windows"] * kw["e"],
    )
    if v3 is None:
        ref_levels = np.asarray(syms).reshape(kw["num_windows"], kw["e"])
    else:
        grid = ref_expand(syms, jv3[0]).reshape(kw["num_windows"], kw["e"])
        ref_levels = np.asarray(ref_unpredict(
            grid.astype(jnp.uint32), jv3[1], *kw["coding"][:2]
        ))

    words_t, sl_t, tables, plut, pbasis, pv3 = _k2_port_inputs(
        ref_tables, words, sl, v3, kw
    )
    lv_kw = {k: v for k, v in kw.items() if k != "n"}
    levels = df.bucket_levels(words_t, sl_t, tables, pv3, **lv_kw)
    np.testing.assert_array_equal(levels.numpy(), ref_levels)
    before = dict(ops.LAUNCHES)
    got = df.decode_fused(words_t, sl_t, tables, plut, pbasis, pv3, **kw)
    assert ops.LAUNCHES == before
    assert got.dtype == torch.float32
    assert_close(got.numpy(), ref)  # every row, padding windows included


@pytest.mark.parametrize("bands", ["1", "2", "e"])
@pytest.mark.parametrize("pred_id", [1, 2])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_v3_stage_plain_matches_reference(layout, pred_id, bands):
    """K2's v3 stage (the card's kernel is held to it) against the
    reference's expand_coded_stream + unpredict_levels, on the adversarial
    segment layouts of tests/_v3_layouts.py at the kernel's tile size."""
    e = 6
    dense, idx, seg, nw = v3_stage_case(layout, e, df.v3_tile_windows(e),
                                        seed=e)
    nb = e if bands == "e" else int(bands)
    grid = ref_expand(jnp.asarray(dense), jnp.asarray(idx)).reshape(nw, e)
    want = np.asarray(ref_unpredict(grid.astype(jnp.uint32),
                                    jnp.asarray(seg), pred_id, nb))
    got = df.v3_expand_unpredict_plain(
        *(torch.from_numpy(a) for a in (dense, idx, seg)), num_windows=nw,
        e=e, pred_id=pred_id, bands=nb)
    np.testing.assert_array_equal(got.numpy(), want)


def test_v3_tile_windows_fit_the_kernel():
    """The tile rule the wrapper passes to the v3 kernel meets the
    launcher's contract for every e it takes: a multiple of 256 windows,
    the tile and its head flags within 44 KiB of shared memory."""
    for e in range(1, 129):
        t = df.v3_tile_windows(e)
        assert t % 256 == 0 and 256 <= t <= 1024 and t * (e + 1) <= 44 * 1024
    for e in (0, 129):
        with pytest.raises(ValueError, match="1 <= e <= 128"):
            df.v3_tile_windows(e)


def test_k2_v3_needs_expansion_arrays():
    ref_tables, words, sl, v3, kw = _k2_case(CODINGS[2])
    words_t, sl_t, tables, plut, pbasis, _ = _k2_port_inputs(
        ref_tables, words, sl, v3, kw
    )
    with pytest.raises(ValueError, match="v3_expand_index"):
        df.decode_fused(words_t, sl_t, tables, plut, pbasis, None, **kw)


# ---------------------------------------------------------------------------
# K3: the fixed-rate dequant + iDCT.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("domain_key,dom_id", [("kv", 5), ("seismic", 1)])
def test_k3_plain_matches_reference_and_pallas(domain_key, dom_id):
    ref_tables = golden_tables(domain_key, dom_id)
    cfg = ref_tables.config
    rng = np.random.default_rng(dom_id)
    levels = rng.integers(0, 256, (300, cfg.e)).astype(np.uint8)
    ref = np.asarray(idct_dequant_ref(jnp.asarray(levels), ref_tables.quant,
                                      n=cfg.n))
    q = ref_tables.quant
    pallas = np.asarray(ref_pallas_idct(
        jnp.asarray(levels), q.zone, q.scale,
        jnp.asarray(dct.idct_basis(cfg.n, cfg.e).numpy()), q.mu, q.alpha1,
        n=cfg.n, interpret=True,
    ))
    t = carry(ref_tables)
    basis = dct.idct_basis(cfg.n, cfg.e)
    got = idq.idct_dequant(torch.from_numpy(levels), t.quant, basis).numpy()
    assert_close(got, ref)
    assert_close(got, pallas)
    # int32 levels holding 0..255 decode the same
    got32 = idq.idct_dequant(torch.from_numpy(levels.astype(np.int32)),
                             t.quant, basis).numpy()
    np.testing.assert_array_equal(got32, got)


# ---------------------------------------------------------------------------
# K5: the fixed-rate DCT + quantize.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("domain_key,dom_id", [("kv", 5), ("seismic", 1)])
def test_k5_plain_matches_pallas_exact_arm(domain_key, dom_id):
    ref_tables = golden_tables(domain_key, dom_id)
    cfg = ref_tables.config
    rng = np.random.default_rng(40 + dom_id)
    # windows scaled to the table, so every zone sees levels across its range
    windows = (rng.standard_normal((300, cfg.n)) * 3.0).astype(np.float32)
    basis = dct.dct_basis(cfg.n, cfg.e)
    q = ref_tables.quant
    ref = np.asarray(ref_pallas_dct_quant(
        jnp.asarray(windows), q.zone, q.scale, jnp.asarray(basis.numpy()),
        q.mu, q.alpha1, e=cfg.e, interpret=True, exact=True,
    ))
    t = carry(ref_tables)
    before = dict(ops.LAUNCHES)
    got = dq.dct_quant(torch.from_numpy(windows), t.quant, e=cfg.e,
                       basis=basis, exact=True)
    assert ops.LAUNCHES == before  # CPU tensors take the plain version
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) > 20  # the levels are not degenerate
    # no basis given: the wrapper builds the same one
    np.testing.assert_array_equal(
        dq.dct_quant(torch.from_numpy(windows), t.quant, e=cfg.e).numpy(),
        ref)


# ---------------------------------------------------------------------------
# K4: the bucket encode.
# ---------------------------------------------------------------------------
K4_CODINGS = [
    {},
    dict(predictor="delta", predict_bands=2, zero_planes=True),
    dict(predictor="linear2", predict_bands=2, zero_planes=True),
    dict(predictor="linear2", predict_bands=3, zero_planes=False),
]
K4_WINDOWS = 32  # Wp: every row's bucket width (N = 32 samples a window)
K4_LENGTHS = (1000, 701, 1024, 0)  # the rows' true samples (the last pads)


def _k4_case(coding, gaps=False):
    """A four-row meteorological bucket: three ragged signals (a partial
    last window, and windows of zero padding) and one padding row.  With
    ``gaps`` the codebook covers only the symbols 120..136, so off-zero
    rows hit histogram gaps and the all-zero row does not."""
    v2 = _k2_v2_tables()
    ref_tables = dataclasses.replace(v2, config=v2.config.replace(**coding))
    if gaps:
        hist = np.zeros(256, np.int64)
        hist[120:137] = 50
        book = ref_huffman.build_codebook(hist, l_max=v2.config.l_max)
        ref_tables = dataclasses.replace(ref_tables, book=book)
    cfg = ref_tables.config
    lengths = K4_LENGTHS
    sig = np.zeros((len(lengths), K4_WINDOWS * cfg.n), np.float32)
    for r, n in enumerate(lengths[:3]):
        sig[r, :n] = make_signal("temperature", n, seed=60 + r)
    if gaps:
        sig[1] = 0.0  # quantizes to the zero bin: no gap in this row
    counts = np.array([-(-n // cfg.n) * cfg.e for n in lengths], np.int32)
    return ref_tables, sig, counts


def _ref_outputs(outs):
    return [None if o is None else np.asarray(o) for o in outs]


def assert_k4_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
            continue
        g = g.numpy()
        if r.dtype == np.uint32:
            g = g.view(np.uint32)
        assert g.shape == r.shape
        np.testing.assert_array_equal(g, r)


# every coding with a full book; the gap book under v2 and one v3 coding
K4_CASES = [(c, False) for c in K4_CODINGS] + [
    (K4_CODINGS[0], True), (K4_CODINGS[1], True)]


@pytest.mark.parametrize("coding,gaps", K4_CASES, ids=lambda c: (
    ("gap-book" if c else "book") if isinstance(c, bool)
    else "-".join(str(v) for v in c.values()) or "v2"))
def test_k4_plain_matches_pallas_and_xla_arm(coding, gaps):
    ref_tables, sig, counts = _k4_case(coding, gaps)
    cfg = ref_tables.config
    dev = ref_tables.device_tables()
    basis = dct.dct_basis(cfg.n, cfg.e)
    kw = dict(n=cfg.n, e=cfg.e, chunk_size=64, check_gaps=gaps,
              coding=cfg.coding)
    xla = _ref_outputs(ref_encode_bucket_math(
        jnp.asarray(sig), jnp.asarray(counts), dev, **kw))
    pallas = _ref_outputs(ref_pallas_encode(
        jnp.asarray(sig), jnp.asarray(counts), dev.codes, dev.lengths,
        dev.quant.zone, dev.quant.scale, dev.quant.mu, dev.quant.alpha1,
        jnp.asarray(basis.numpy()), interpret=True, **kw))
    t = carry(ref_tables).device_tables("cpu")
    before = dict(ops.LAUNCHES)
    got = ef.encode_fused(torch.from_numpy(sig), torch.from_numpy(counts), t,
                          basis, **kw)
    assert ops.LAUNCHES == before  # CPU tensors take the plain version
    if cfg.coding == (0, 0, False):
        assert len(got) == 5
    else:  # the reference's v3 contract: zrow/zcol None without zero planes
        got = list(got)
        pallas[6:] = [None if not cfg.zero_planes else p for p in pallas[6:]]
    assert_k4_equal(got, xla)
    assert_k4_equal(got, pallas)
    bad = got[4].numpy()
    assert bad.tolist() == ([True, False, True, False] if gaps
                            else [False] * 4)
    # the two stages, and their composition in the plain arm, agree
    plain = ef.encode_fused_plain(torch.from_numpy(sig),
                                  torch.from_numpy(counts), t, basis, **kw)
    assert_k4_equal(list(plain), xla)


def test_k4_exact_chunk_equals_host_packer():
    """One chunk per row (exact mode): each row's words are
    ``pack_symlen_np`` of its coded symbols."""
    ref_tables, sig, counts = _k4_case(K4_CODINGS[1])
    cfg = ref_tables.config
    t = carry(ref_tables)
    basis = dct.dct_basis(cfg.n, cfg.e)
    sp = K4_WINDOWS * cfg.e
    hi, lo, sl, wpc, bad, ncoded, zrow, zcol = ef.encode_fused(
        torch.from_numpy(sig), torch.from_numpy(counts),
        t.device_tables("cpu"), basis, n=cfg.n, e=cfg.e, chunk_size=sp,
        check_gaps=False, coding=cfg.coding)
    grid, *_ = ef.encode_levels_plain(
        torch.from_numpy(sig), torch.from_numpy(counts), t.quant, basis,
        n=cfg.n, e=cfg.e, coding=cfg.coding)
    for r in range(3):
        nw = int(counts[r]) // cfg.e
        g = grid[r, :nw].numpy()
        coded = g[~zrow[r, :nw].numpy()][:, ~zcol[r].numpy()].ravel()
        assert coded.size == int(ncoded[r])
        host = symlen.pack_symlen_np(coded, t.book)
        w = int(wpc[r, 0])
        np.testing.assert_array_equal(
            symlen.u32_to_words(hi[r, 0, :w].numpy().view(np.uint32),
                                lo[r, 0, :w].numpy().view(np.uint32)),
            host.words)
        np.testing.assert_array_equal(sl[r, 0, :w].numpy(), host.symlen)
        assert not hi[r, 0, w:].any() and not sl[r, 0, w:].any()


# ---------------------------------------------------------------------------
# K6: the slot-major decode tile.
# ---------------------------------------------------------------------------
def _ref_tile(hi, lo, book, *, max_symlen, block_words):
    """The reference's Pallas tile kernel in interpret mode."""
    return np.asarray(ref_pallas_tile(
        jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(book.limit_shifted[1:], jnp.uint32),
        jnp.asarray(book.first_code_shifted, jnp.uint32),
        jnp.asarray(book.rank_offset, jnp.int32),
        jnp.asarray(book.sorted_symbols, jnp.int32),
        l_max=book.l_max, max_symlen=max_symlen, block_words=block_words,
        interpret=True,
    ))


def _check_tile(words, sl, syms, book, *, max_symlen, block_words):
    hi, lo = ref_symlen.words_to_u32(words)
    want = _ref_tile(hi, lo, book, max_symlen=max_symlen,
                     block_words=block_words)
    tables = carry_book(book).device_tables("cpu")
    w = torch.from_numpy(words.view(np.int64))
    before = dict(ops.LAUNCHES)
    tile = hd.huffman_decode_tile(w, tables, l_max=book.l_max,
                                  max_symlen=max_symlen)
    assert ops.LAUNCHES == before  # CPU tensors take the plain version
    assert tile.dtype == torch.int32 and tile.shape == (max_symlen,
                                                        words.size)
    np.testing.assert_array_equal(tile.numpy(), want)  # the WHOLE tile
    np.testing.assert_array_equal(
        hd.huffman_decode_padded(w, tables, l_max=book.l_max,
                                 max_symlen=max_symlen).numpy(), want.T)
    # compacted: the dense stream of unpack_symlen, and the symbols
    sl_t = torch.from_numpy(sl.astype(np.int32))
    dense = symlen.compact_padded_scatter(tile.T, sl_t, syms.size)
    np.testing.assert_array_equal(dense.numpy().astype(np.uint8), syms)
    np.testing.assert_array_equal(
        dense.numpy().astype(np.uint8),
        hd.huffman_decode_dense(w, torch.from_numpy(sl.astype(np.uint8)),
                                tables, l_max=book.l_max,
                                max_symlen=max_symlen,
                                num_symbols=syms.size).numpy())


@pytest.mark.parametrize("l_max", [8, 12])
@pytest.mark.parametrize("n_syms", [100, 4096, 7000])
def test_k6_plain_matches_pallas_tile(l_max, n_syms):
    """The cases of ``tests/test_kernels.py``'s tile test, plus zero padding
    words past the stream (their slots decode too)."""
    rng = np.random.default_rng(l_max * 1000 + n_syms)
    syms = np.clip(rng.zipf(1.4, n_syms), 0, 255).astype(np.uint8)
    freqs = np.bincount(syms, minlength=256).astype(np.int64) + 1
    book = ref_huffman.build_codebook(freqs, l_max=l_max)
    stream = ref_symlen.pack_symlen_np(syms, book)
    words = np.concatenate([stream.words, np.zeros(37, np.uint64)])
    sl = np.concatenate([stream.symlen, np.zeros(37, np.uint8)])
    _check_tile(words, sl, syms, book, max_symlen=stream.max_symlen,
                block_words=128)


@pytest.mark.parametrize("seed,num_symbols,chunk,l_max", [
    (10, 2000, 64, 12),
    (11, 63, 7, 8),
    (12, 4096, 1024, 16),
    (13, 1, 1, 9),
    (14, 500, 501, 10),
])
def test_k6_plain_matches_pallas_tile_on_chunked_streams(seed, num_symbols,
                                                         chunk, l_max):
    """The pinned pack cases of ``tests/test_properties.py``: a chunked
    stream (the reference's XLA packer) decoded by the tile, whole."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(1.3, max(num_symbols, 1))[:num_symbols]
    syms = np.clip(raw, 0, 255).astype(np.uint8)
    freqs = np.bincount(syms, minlength=256).astype(np.int64) + 1
    book = ref_huffman.build_codebook(freqs, l_max=l_max)
    hi, lo, sl, nw = ref_symlen.pack_symlen_chunked(
        jnp.asarray(syms), jnp.asarray(book.codes, jnp.uint32),
        jnp.asarray(book.lengths, jnp.int32), chunk_size=chunk)
    nw = int(nw)
    words = ref_symlen.u32_to_words(np.asarray(hi[:nw]), np.asarray(lo[:nw]))
    sl = np.asarray(sl[:nw])
    _check_tile(words, sl, syms, book, max_symlen=max(int(sl.max()), 1),
                block_words=64)


def test_k6_guards():
    book = _k1_case(8)[0]
    tables = carry_book(book).device_tables("cpu")
    w = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="max_symlen"):
        hd.huffman_decode_tile(w, tables, l_max=8, max_symlen=65)
    assert hd.huffman_decode_tile(w, tables, l_max=8,
                                  max_symlen=0).shape == (0, 4)
    with pytest.raises(ValueError, match="device"):
        hd.huffman_decode_tile(w.to("meta"), tables, l_max=8, max_symlen=8)


# ---------------------------------------------------------------------------
# K4's gather arm: rows as runs of a flat sample tensor.
# ---------------------------------------------------------------------------
def _gather_case(sig, n, width, seed=0):
    """K4 bucket rows laid out as runs of a flat tensor, as the transcoder
    flattens decoded windows: row r's run is its true samples followed by
    foreign data up to its window boundary (not zeros), the flat tensor is
    padded by ``width``, and (starts, lens) describe the rows — the padding
    row is (0, 0)."""
    rng = np.random.default_rng(seed)
    lens = K4_LENGTHS
    runs = []
    for r, m in enumerate(lens):
        run = sig[r, :-(-m // n) * n].copy()
        run[m:] = rng.standard_normal(run.size - m)
        runs.append(run)
    starts = np.cumsum([0] + [r.size for r in runs[:-1]])
    flat = np.concatenate(runs + [np.zeros(width, np.float32)])
    st = np.where(np.array(lens) > 0, starts, 0).astype(np.int32)
    return flat.astype(np.float32), st, np.array(lens, np.int32)


def test_gather_rows_matches_reference():
    ref_tables, sig, counts = _k4_case(K4_CODINGS[0])
    cfg = ref_tables.config
    width = K4_WINDOWS * cfg.n
    flat, st, ln = _gather_case(sig, cfg.n, width)
    want = np.asarray(ref_gather_rows(jnp.asarray(flat), jnp.asarray(st),
                                      jnp.asarray(ln), width))
    got = _gather_rows_math(torch.from_numpy(flat), torch.from_numpy(st),
                            torch.from_numpy(ln), width)
    np.testing.assert_array_equal(got.numpy(), want)
    # past lens the row is exact zero, though the flat tensor is not
    assert not got[1, 701:].any() and not got[3].any()
    assert flat[st[1] + 701:st[1] + 710].any()


@pytest.mark.parametrize("coding", K4_CODINGS[:2], ids=["v2", "v3"])
def test_k4_gather_arm_matches_reference(coding):
    """On the K4 case's rows, the gathered bucket encode equals the
    reference's gather arm, and the port's own dense arm on the gathered
    matrix."""
    ref_tables, sig, counts = _k4_case(coding)
    cfg = ref_tables.config
    width = K4_WINDOWS * cfg.n
    flat, st, ln = _gather_case(sig, cfg.n, width)
    kw = dict(n=cfg.n, e=cfg.e, chunk_size=64, check_gaps=False,
              coding=cfg.coding)
    want = _ref_outputs(ref_encode_bucket_gather_math(
        jnp.asarray(flat), jnp.asarray(st), jnp.asarray(ln),
        jnp.asarray(counts), ref_tables.device_tables(), width=width, **kw))
    t = carry(ref_tables).device_tables("cpu")
    basis = dct.dct_basis(cfg.n, cfg.e)
    args = (torch.from_numpy(flat), torch.from_numpy(st),
            torch.from_numpy(ln))
    got = list(_encode_bucket_gather_math(*args, torch.from_numpy(counts), t,
                                          basis, width=width, **kw))
    dense = list(_encode_bucket_math(_gather_rows_math(*args, width),
                                     torch.from_numpy(counts), t, basis,
                                     **kw))
    if cfg.coding != (0, 0, False) and not cfg.zero_planes:
        want[6:] = [None, None]
    assert_k4_equal(got, want)
    for g, d in zip(got, dense):
        assert (g is None and d is None) or torch.equal(g, d)
    levels = ef.encode_levels_gather(*args, torch.from_numpy(counts),
                                     t.quant, basis, width=width, n=cfg.n,
                                     e=cfg.e, coding=cfg.coding)
    assert torch.equal(levels[0], ef.encode_levels_plain(
        _gather_rows_math(*args, width), torch.from_numpy(counts), t.quant,
        basis, n=cfg.n, e=cfg.e, coding=cfg.coding)[0])


# ---------------------------------------------------------------------------
# The kernel layer's guards.
# ---------------------------------------------------------------------------
def test_check_encode_i32_same_boundary():
    limit = np.iinfo(np.int32).max
    ok = ((limit // 8) * 32, 8, 32)  # width, e, n: limit // 8 * 8 symbols
    ref_ops._check_encode_i32(*ok)
    ops._check_encode_i32(*ok)
    over = ((limit // 8 + 1) * 32, 8, 32)
    for fn in (ref_ops._check_encode_i32, ops._check_encode_i32):
        with pytest.raises(ValueError, match="int32"):
            fn(*over)


def test_check_i32_offsets_same_boundary():
    limit = np.iinfo(np.int32).max
    for num, ms in ((limit - 64, 64), (limit - 8, 8), (0, 64)):
        ref_ops.check_i32_offsets(num, ms)
        ops.check_i32_offsets(num, ms)
    for num, ms in ((limit - 63, 64), (limit, 1), (1 << 31, 0)):
        with pytest.raises(ValueError, match="int32"):
            ref_ops.check_i32_offsets(num, ms)
        with pytest.raises(ValueError, match="int32"):
            ops.check_i32_offsets(num, ms)


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; any other
    device that is not CUDA is refused, never quietly computed."""
    meta = torch.empty(8, dtype=torch.int64, device="meta")
    tables = carry_book(_k1_case(8)[0]).device_tables("cpu")
    with pytest.raises(ValueError, match="device"):
        hd.huffman_decode_dense(meta, meta.to(torch.uint8), tables, l_max=8,
                                max_symlen=8, num_symbols=8)
    with pytest.raises(ValueError, match="device"):
        df.lut_idct(torch.empty(4, 8, dtype=torch.uint8, device="meta"),
                    torch.empty(8, 256), torch.empty(8, 8))


def test_kernel_library_is_not_built_on_import():
    assert ops._lib is None or torch.cuda.is_available()
