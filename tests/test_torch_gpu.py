"""The CUDA kernels on the card, each against its plain PyTorch version on
the same inputs, and the batched decode and encode engines and the
transcoder on the card against themselves on the CPU.  Every test is marked ``gpu`` and skips where there is no card;
on the card run ``python -m pytest -m gpu tests/test_torch_*.py``.

This file imports neither JAX nor the reference package, so it runs where
they are absent; its inputs come from the port's own host encoder, made
from seeds with numpy.  Symbols and levels must be equal; floats within
``max|d| <= 1e-5 * max|plain|`` (the kernels sum the iDCT product in a
fixed sequential fp32 FMA order, the plain versions in cuBLAS's order, with
TF32 off).  The encode kernels' forward DCT sums in another order than the
plain ``windows @ basis``, so a coefficient within an ulp of a quantizer
cell boundary can land one level away: with an identity basis (the
coefficients are the inputs) levels must be equal, and with the DCT basis
every differing level must differ by one (the flip rule), in at most 1e-5
of the cells (or one cell, at these small sizes).  Packing the same grid must give equal words.

The serving frontend on the card (no device given) answers byte-identically
to the offline engines on the card, corrupt blobs included as typed
outcomes, and two frontends serving at once on the default stream keep the
kernels' shared state (K1's workspace, the launch counters) coherent.  The
workloads: ``KVCacheCodec`` waits for the card nowhere and matches K5's and
K3's plain versions; a compressed checkpoint at n = e = 64 holds every
kernel call to its plain version and restores within relative rms 0.02.
The LM path: the ten smoke models it serves (the MoE, MLA, hybrid, RWKV
and encoder-decoder families among them) on the card against the CPU, and
decode steps that wait for the card nowhere.
LM training: the smoke granite's and the smoke deepseek-v3's (MoE + MLA)
train steps on the card track the CPU's within the CPU trajectory bounds,
a raw checkpoint resumes bit for bit and a compressed one through counted
K4, K1 and ``lut_idct`` launches.  Two ranks on the card in a gloo group
(``tests/_mesh_ranks.py``): the smoke granite's pod-compressed steps equal
the one-process oracle (each replica's gradients in turn,
``replica_sum`` on the reference's leaves, ``AdamW.update``) bit for
bit."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import DOMAIN_DEFAULTS, calibrate, codec, dct
from repro_torch.core.container import Container
from repro_torch.core.huffman import build_codebook, codebook_from_lengths
from repro_torch.core.quantize import quant_grid
from repro_torch.core.symlen import (
    compact_padded_scatter,
    pack_symlen_np,
    v3_expand_index,
)
from repro_torch.data import make_signal
from repro_torch.kernels import dct_quant as dq
from repro_torch.kernels import decode_fused as df
from repro_torch.kernels import encode_fused as ef
from repro_torch.kernels import huffman_decode as hd
from repro_torch.kernels import idct_dequant as idq
from repro_torch.kernels import ops
from repro_torch.serving import BatchDecoder, BatchEncoder, Transcoder
from repro_torch.serving.engine import p2, symlen_bucket
from _pack_layouts import CHUNKS as PACK_CHUNKS
from _pack_layouts import LAYOUTS as PACK_LAYOUTS
from _pack_layouts import pack_case
from _levels_layouts import CODINGS as LEVEL_CODINGS
from _levels_layouts import PAIRS, dct_case, levels_case, walk_rows, widths
from _idct_layouts import PAIRS as IDCT_PAIRS
from _idct_layouts import every_level, idct_case
from _idct_layouts import widths as idct_widths
from _v3_layouts import LAYOUTS, v3_stage_case
from _symlen_layouts import BIG as SYMLEN_BIG
from _symlen_layouts import COUNTS as SYMLEN_COUNTS
from _symlen_layouts import L_MAXES
from _symlen_layouts import LAYOUTS as SYMLEN_LAYOUTS
from _symlen_layouts import num_symbols_cases, symlen_case

pytestmark = pytest.mark.gpu

REL_TOL = 1e-5
FLIP_SHARE = 1e-5  # flips allowed per level cell with the DCT basis
CODINGS = [
    {},
    dict(predictor="delta", predict_bands=2, zero_planes=False),
    dict(predictor="delta", predict_bands=2, zero_planes=True),
    dict(predictor="linear2", predict_bands=3, zero_planes=False),
    dict(predictor="linear2", predict_bands=2, zero_planes=True),
]


@pytest.fixture
def cuda():
    """The card, decided per test (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def assert_close(got, want, rel=REL_TOL):
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got).all())
    bound = rel * max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= bound


def _tables(domain, dataset, coding, domain_id=0):
    cfg = DOMAIN_DEFAULTS[domain].replace(**coding)
    return calibrate(make_signal(dataset, 16384, seed=domain_id), cfg,
                     domain_id=domain_id)


@pytest.mark.parametrize("l_max", [8, 12, 16])
def test_k1_kernel_matches_plain(cuda, l_max):
    rng = np.random.default_rng(l_max)
    hist = (2.0 ** rng.uniform(0, 20, 256)).astype(np.int64) + 1
    book = build_codebook(hist, l_max=l_max)
    syms = rng.choice(256, size=20000, p=hist / hist.sum()).astype(np.uint8)
    stream = pack_symlen_np(syms, book)
    wp = p2(stream.num_words) + 3
    words = np.zeros(wp, np.uint64)
    words[:stream.num_words] = stream.words
    sl = np.zeros(wp, np.uint8)
    sl[:stream.num_words] = stream.symlen
    from repro_torch.core.calibration import DomainTables
    from repro_torch.core.config import CodecConfig
    from repro_torch.core.quantize import quant_table_from_arrays

    tables = DomainTables(
        config=CodecConfig(n=8, e=8, b1=0, b2=8, l_max=l_max),
        quant=quant_table_from_arrays(np.zeros(8), np.ones(8), 50.0, 0.0),
        book=book,
    ).device_tables(cuda)
    w = torch.from_numpy(words.view(np.int64)).to(cuda)
    s = torch.from_numpy(sl).to(cuda)
    kw = dict(l_max=l_max, max_symlen=symlen_bucket(stream.max_symlen),
              num_symbols=syms.size + 41)
    before = ops.LAUNCHES["symlen_decode"]
    got = hd.huffman_decode_dense(w, s, tables, **kw)
    assert ops.LAUNCHES["symlen_decode"] == before + 1
    want = hd.huffman_decode_plain(w, s, tables, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got[:syms.size].cpu().numpy(), syms)
    assert not got[syms.size:].any()


@pytest.mark.parametrize("l_max", [8, 12, 16])
def test_k6_kernel_matches_plain(cuda, l_max):
    """The whole tile (slots past each word's symlen and zero padding words
    included) equals the plain version; compacted, K1's dense output."""
    rng = np.random.default_rng(100 + l_max)
    hist = (2.0 ** rng.uniform(0, 20, 256)).astype(np.int64) + 1
    book = build_codebook(hist, l_max=l_max)
    syms = rng.choice(256, size=30001, p=hist / hist.sum()).astype(np.uint8)
    stream = pack_symlen_np(syms, book)
    wp = p2(stream.num_words) + 77
    words = np.zeros(wp, np.uint64)
    words[:stream.num_words] = stream.words
    sl = np.zeros(wp, np.uint8)
    sl[:stream.num_words] = stream.symlen
    from repro_torch.core.calibration import DomainTables
    from repro_torch.core.config import CodecConfig
    from repro_torch.core.quantize import quant_table_from_arrays

    tables = DomainTables(
        config=CodecConfig(n=8, e=8, b1=0, b2=8, l_max=l_max),
        quant=quant_table_from_arrays(np.zeros(8), np.ones(8), 50.0, 0.0),
        book=book,
    ).device_tables(cuda)
    w = torch.from_numpy(words.view(np.int64)).to(cuda)
    s = torch.from_numpy(sl).to(cuda)
    for ms in (stream.max_symlen, 64):
        before = ops.LAUNCHES["symlen_tile"]
        got = hd.huffman_decode_tile(w, tables, l_max=l_max, max_symlen=ms)
        assert ops.LAUNCHES["symlen_tile"] == before + 1
        want = hd.huffman_decode_tile_plain(w, tables, l_max=l_max,
                                            max_symlen=ms)
        torch.cuda.synchronize()
        assert got.shape == (ms, wp) and torch.equal(got, want)
        dense = compact_padded_scatter(got.T, s, syms.size + 41)
        k1 = hd.huffman_decode_dense(w, s, tables, l_max=l_max,
                                     max_symlen=symlen_bucket(ms),
                                     num_symbols=syms.size + 41)
        assert torch.equal(dense.to(torch.uint8), k1)
        np.testing.assert_array_equal(k1[:syms.size].cpu().numpy(), syms)


@pytest.mark.parametrize("coding", CODINGS, ids=lambda c: "-".join(
    str(v) for v in c.values()) or "v2")
def test_encode_levels_gather_kernel_matches_plain(cuda, coding):
    """Rows read through (flat, starts, lens) give the levels
    ``encode_levels`` gives on the materialized rows, bit for bit — the
    same arithmetic on the same staged samples — with the DCT basis and
    with the identity basis; and with the identity basis the plain
    version's too."""
    cfg = DOMAIN_DEFAULTS["meteorological"].replace(e=32, b2=32, **coding)
    tab = calibrate(make_signal("temperature", 16384, seed=0), cfg)
    lengths = (3000, 1500, 0, 4096, 701)
    wp = p2(max(-(-m // 32) for m in lengths))
    rng = np.random.default_rng(7)
    runs, starts = [], []
    off = 0
    for r, m in enumerate(lengths):
        run = np.concatenate([make_signal("temperature", m, seed=40 + r)
                              if m else np.zeros(0, np.float32),
                              rng.standard_normal(-m % 32 + 5)])
        runs.append(run.astype(np.float32))
        starts.append(off)
        off += run.size
    flat = np.concatenate(runs + [np.zeros(wp * 32, np.float32)])
    st = torch.tensor(starts + [0], dtype=torch.int32, device=cuda)
    ln = torch.tensor(list(lengths) + [0], dtype=torch.int32, device=cuda)
    counts = torch.tensor([-(-m // 32) * 32 for m in lengths] + [0],
                          dtype=torch.int32, device=cuda)
    flat_t = torch.from_numpy(flat).to(cuda)
    x = ef.gather_rows(flat_t, st, ln, wp * 32)
    q = tab.device_tables(cuda).quant
    for basis in (torch.eye(32, device=cuda),
                  dct.dct_basis(32, 32, device=cuda)):
        kw = dict(n=32, e=32, coding=cfg.coding)
        before = dict(ops.LAUNCHES)
        got = ef.encode_levels_gather(flat_t, st, ln, counts, q, basis,
                                      width=wp * 32, **kw)
        assert ops.LAUNCHES["encode_levels_gather"] == (
            before["encode_levels_gather"] + 1)
        assert ops.LAUNCHES["encode_levels"] == before["encode_levels"]
        want = ef.encode_levels(x, counts, q, basis, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            assert g is None or (g.dtype == w.dtype and torch.equal(g, w))
    eye = torch.eye(32, device=cuda)
    got = ef.encode_levels_gather(flat_t, st, ln, counts, q, eye,
                                  width=wp * 32, n=32, e=32,
                                  coding=cfg.coding)
    want = ef.encode_levels_gather_plain(flat_t, st, ln, counts, q, eye,
                                         width=wp * 32, n=32, e=32,
                                         coding=cfg.coding)
    for g, w in zip(got, want):
        assert g is None or torch.equal(g, w)


@pytest.mark.parametrize("coding", CODINGS, ids=lambda c: "-".join(
    str(v) for v in c.values()) or "v2")
def test_k2_kernel_matches_plain(cuda, coding):
    tab = _tables("meteorological", "temperature", coding)
    cs = [codec.encode(make_signal("temperature", n, seed=10 + i), tab)
          for i, n in enumerate((3000, 1500, 701))]
    nw = p2(sum(c.num_windows for c in cs))
    words = np.concatenate([c.words for c in cs])
    sl = np.concatenate([c.symlen for c in cs])
    wp = p2(words.size)
    words = np.concatenate([words, np.zeros(wp - words.size, np.uint64)])
    sl = np.concatenate([sl, np.zeros(wp - sl.size, np.uint8)])
    cfg = tab.config
    v3 = None
    if cfg.coding != (0, 0, False):
        idx, seg = v3_expand_index(
            [(c.num_windows, c.zrow, c.zcol) for c in cs], cfg.e,
            total_windows=nw,
        )
        v3 = (torch.from_numpy(idx).to(cuda), torch.from_numpy(seg).to(cuda))
    args = (
        torch.from_numpy(words.view(np.int64)).to(cuda),
        torch.from_numpy(sl).to(cuda), tab.device_tables(cuda),
    )
    lut = quant_grid(tab.quant)[0].to(cuda)
    basis = dct.idct_basis(cfg.n, cfg.e, device=cuda)
    kw = dict(l_max=cfg.l_max, max_symlen=symlen_bucket(int(sl.max())),
              num_windows=nw, e=cfg.e, coding=cfg.coding)
    lv = df.bucket_levels(*args, v3, **kw)
    lvp = df.bucket_levels_plain(*args, v3, **kw)
    before = dict(ops.LAUNCHES)
    got = df.decode_fused(*args, lut, basis, v3, n=cfg.n, **kw)
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == {
        "symlen_decode": 1, "v3_unpredict": int(v3 is not None),
        "lut_idct": 1, "idct_dequant": 0, "encode_levels": 0,
        "encode_levels_gather": 0, "symlen_pack": 0, "dct_quant": 0,
        "symlen_tile": 0, "symlen_lut": 0,
    }
    want = df.decode_fused_plain(*args, lut, basis, v3, n=cfg.n, **kw)
    torch.cuda.synchronize()
    assert torch.equal(lv, lvp)
    assert_close(got, want)


@pytest.mark.parametrize("e", [6, 32])
@pytest.mark.parametrize("bands", ["1", "2", "e"])
@pytest.mark.parametrize("pred_id", [1, 2])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_v3_stage_kernel_matches_plain(cuda, layout, pred_id, bands, e):
    """K2's v3 stage on adversarial segment layouts (tests/_v3_layouts.py):
    single windows, one segment across every tile, heads on, one before
    and one after a tile's first window, random lengths; trailing padding
    and a ragged last tile.  Levels must be equal."""
    dense, idx, seg, nw = v3_stage_case(layout, e, df.v3_tile_windows(e),
                                        seed=e)
    kw = dict(num_windows=nw, e=e, pred_id=pred_id,
              bands=e if bands == "e" else int(bands))
    args = [torch.from_numpy(a).to(cuda) for a in (dense, idx, seg)]
    before = ops.LAUNCHES["v3_unpredict"]
    got = df.v3_expand_unpredict_cuda(*args, **kw)
    assert ops.LAUNCHES["v3_unpredict"] == before + 1
    want = df.v3_expand_unpredict_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("domain,n_windows", [("kv", 4099), ("seismic", 333)])
def test_k3_kernel_matches_plain(cuda, domain, n_windows):
    tab = _tables(domain, "mitbih", {})
    e, n = tab.config.e, tab.config.n
    rng = np.random.default_rng(n_windows)
    levels = torch.from_numpy(
        rng.integers(0, 256, (n_windows, e)).astype(np.uint8)
    ).to(cuda)
    q = tab.device_tables(cuda).quant
    basis = dct.idct_basis(n, e, device=cuda)
    before = ops.LAUNCHES["idct_dequant"]
    got = idq.idct_dequant(levels, q, basis)
    assert ops.LAUNCHES["idct_dequant"] == before + 1
    want = idq.idct_dequant_plain(levels, q, basis)
    torch.cuda.synchronize()
    assert_close(got, want)


def test_wrappers_check_their_inputs(cuda):
    tab = _tables("power", "load_power", {})
    tables = tab.device_tables(cuda)
    w = torch.zeros(8, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="uint8 symlen"):
        hd.huffman_decode_dense(w, w.to(torch.int32), tables, l_max=12,
                                max_symlen=8, num_symbols=8)
    with pytest.raises(ValueError, match="l_max"):
        hd.huffman_decode_dense(w, w.to(torch.uint8), tables, l_max=8,
                                max_symlen=8, num_symbols=8)
    with pytest.raises(TypeError, match="uint8 levels"):
        df.lut_idct(torch.zeros(4, 6, dtype=torch.int32, device=cuda),
                    torch.zeros(6, 256, device=cuda),
                    torch.zeros(6, 32, device=cuda))
    dense = torch.zeros(8, dtype=torch.uint8, device=cuda)
    idx = torch.zeros(4 * 6, dtype=torch.int32, device=cuda)
    seg = torch.arange(4, dtype=torch.int32, device=cuda)
    v3_kw = dict(num_windows=4, e=6, pred_id=2)
    with pytest.raises(TypeError, match="flat uint8"):
        df.v3_expand_unpredict_cuda(dense.int(), idx, seg, bands=2, **v3_kw)
    with pytest.raises(ValueError, match="predict_bands"):
        df.v3_expand_unpredict_cuda(dense, idx, seg, bands=7, **v3_kw)
    with pytest.raises(ValueError, match="1 <= e <= 128"):
        df.v3_expand_unpredict_cuda(
            dense, torch.zeros(4 * 129, dtype=torch.int32, device=cuda), seg,
            num_windows=4, e=129, pred_id=2, bands=2)


def test_engine_on_card_matches_cpu(cuda):
    """The whole slice on the card: a mixed v2/v3 archive through
    ``BatchDecoder()`` (the card by default) against the same engine on the
    CPU, with the launch counters showing the kernels ran."""
    archive, tables = [], {}
    specs = [("biomedical", "mitbih"), ("seismic", "seismic"),
             ("power", "load_power"), ("meteorological", "temperature")]
    for j, coding in enumerate(CODINGS[::2]):
        for d, (dom, ds) in enumerate(specs):
            did = 4 * j + d
            tables[did] = _tables(dom, ds, coding, domain_id=did)
            for i, n in enumerate((5000, 777)):
                sig = make_signal(ds, n, seed=100 + did * 2 + i)
                blob = codec.encode(sig, tables[did]).to_bytes()
                archive.append(Container.from_bytes(blob))
    ops.reset_launches()
    dec = BatchDecoder()
    assert dec.device.type == "cuda"
    out = dec.decode(archive, tables).to_host()
    groups = len(tables)
    v3_groups = sum(t.config.coding != (0, 0, False) for t in tables.values())
    assert ops.LAUNCHES["symlen_decode"] == groups
    assert ops.LAUNCHES["lut_idct"] == groups
    assert ops.LAUNCHES["v3_unpredict"] == v3_groups
    ref = BatchDecoder(device="cpu").decode(archive, tables).to_host()
    for got, want, c in zip(out, ref, archive):
        assert_close(torch.from_numpy(got), torch.from_numpy(want))
        assert got.shape == (c.signal_length,)
    single = codec.decode_device(archive[0], tables[archive[0].domain_id])
    assert_close(torch.from_numpy(single), torch.from_numpy(ref[0]))
    dec.close()


# ---------------------------------------------------------------------------
# The encode kernels: K5 (dct_quant) and K4 (encode_levels, symlen_pack).
# ---------------------------------------------------------------------------
def assert_flip_rule(got, want):
    """Levels equal, or one level apart in at most FLIP_SHARE of the cells
    (at least one flip is allowed at these small sizes)."""
    assert got.shape == want.shape
    d = (got.int() - want.int()).abs()
    assert d.numel() == 0 or int(d.max()) <= 1
    assert int((d > 0).sum()) <= max(1.0, FLIP_SHARE * d.numel())


def _kv_windows(cuda, rows, n, seed):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((rows, n)), axis=1) * 0.2
    return torch.from_numpy(x.astype(np.float32)).to(cuda)


@pytest.mark.parametrize("domain", ["kv", "seismic"])
def test_k5_kernel_matches_plain(cuda, domain):
    tab = _tables(domain, "mitbih", {})
    n, e = tab.config.n, tab.config.e
    q = tab.device_tables(cuda).quant
    windows = _kv_windows(cuda, 5003, n, seed=n)
    # identity basis (both domains have n = e): the quantizer alone, exactly
    assert n == e
    eye = torch.eye(n, device=cuda)
    before = ops.LAUNCHES["dct_quant"]
    got = dq.dct_quant(windows, q, e=e, basis=eye)
    assert ops.LAUNCHES["dct_quant"] == before + 1
    want = dq.dct_quant_plain(windows, q, eye)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # the DCT basis: the flip rule
    basis = dct.dct_basis(n, e, device=cuda)
    got = dq.dct_quant(windows, q, e=e, basis=basis, exact=True)
    assert_flip_rule(got, dq.dct_quant_plain(windows, q, basis))


def _encode_rows(cuda, tab, lengths, seed):
    cfg = tab.config
    wp = p2(max(-(-n // cfg.n) for n in lengths))
    sig = np.zeros((len(lengths), wp * cfg.n), np.float32)
    for r, n in enumerate(lengths):
        if n:
            sig[r, :n] = make_signal("temperature", n, seed=seed + r)
    counts = np.array([-(-n // cfg.n) * cfg.e for n in lengths], np.int32)
    return (torch.from_numpy(sig).to(cuda), torch.from_numpy(counts).to(cuda))


@pytest.mark.parametrize("coding", CODINGS, ids=lambda c: "-".join(
    str(v) for v in c.values()) or "v2")
def test_encode_levels_kernel_matches_plain(cuda, coding):
    # n = e: with an identity basis every output must be equal
    cfg = DOMAIN_DEFAULTS["meteorological"].replace(e=32, b2=32, **coding)
    tab = calibrate(make_signal("temperature", 16384, seed=0), cfg)
    sig, counts = _encode_rows(cuda, tab, (3000, 1500, 0, 4096, 701), 20)
    q = tab.device_tables(cuda).quant
    eye = torch.eye(32, device=cuda)
    kw = dict(n=32, e=32, coding=cfg.coding)
    before = ops.LAUNCHES["encode_levels"]
    got = ef.encode_levels(sig, counts, q, eye, **kw)
    assert ops.LAUNCHES["encode_levels"] == before + 1
    want = ef.encode_levels_plain(sig, counts, q, eye, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)
    # the DCT basis, v2 (the grid is the levels): the flip rule
    basis = dct.dct_basis(32, 32, device=cuda)
    grid = ef.encode_levels(sig, counts, q, basis, n=32, e=32)[0]
    assert_flip_rule(grid, ef.encode_levels_plain(sig, counts, q, basis,
                                                  n=32, e=32)[0])


@pytest.mark.parametrize("chunk", [64, 1000, None])
@pytest.mark.parametrize("coding", CODINGS[::2], ids=lambda c: "-".join(
    str(v) for v in c.values()) or "v2")
def test_symlen_pack_kernel_matches_plain(cuda, coding, chunk):
    cfg = DOMAIN_DEFAULTS["meteorological"].replace(**coding)
    tab = calibrate(make_signal("temperature", 16384, seed=0), cfg)
    sig, counts = _encode_rows(cuda, tab, (3000, 1500, 0, 4096, 701), 30)
    dt = tab.device_tables(cuda)
    basis = dct.dct_basis(cfg.n, cfg.e, device=cuda)
    grid, zrow, zcol, _ = ef.encode_levels_plain(
        sig, counts, dt.quant, basis, n=cfg.n, e=cfg.e, coding=cfg.coding)
    sp = grid.shape[1] * grid.shape[2]
    kw = dict(chunk_size=sp if chunk is None else chunk, coding=cfg.coding)
    args = (grid, zrow, zcol, counts, dt.codes, dt.lengths)
    before = ops.LAUNCHES["symlen_pack"]
    got = ef.symlen_pack(*args, **kw)
    assert ops.LAUNCHES["symlen_pack"] == before + 1
    want = ef.symlen_pack_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # a canonical book with gaps (absent symbols: length 0, code 0): the
    # rows that reach them are flagged
    lengths = tab.book.lengths.copy()
    lengths[:100] = 0
    book = codebook_from_lengths(lengths, cfg.l_max)
    codes = torch.from_numpy(book.codes.astype(np.int64)).to(cuda)
    lens = torch.from_numpy(book.lengths.astype(np.int32)).to(cuda)
    got = ef.symlen_pack(grid, zrow, zcol, counts, codes, lens, **kw)
    want = ef.symlen_pack_plain(grid, zrow, zcol, counts, codes, lens, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[4].any())


@pytest.mark.parametrize("chunk", PACK_CHUNKS,
                         ids=lambda c: "exact" if c is None else str(c))
@pytest.mark.parametrize("layout", PACK_LAYOUTS)
def test_symlen_pack_kernel_matches_plain_on_layouts(cuda, layout, chunk):
    """The tiled pack on the adversarial layouts of tests/_pack_layouts.py
    (words ending at bit 64, word starts on and beside tile edges, gap
    symbols after full words, masked chunks and tiles, 1- and 16-bit codes,
    partial last chunks, exact mode): every output exactly."""
    c = pack_case(layout, chunk)
    args = [None if c[k] is None else torch.from_numpy(c[k]).to(cuda)
            for k in ("grid", "zrow", "zcol", "counts", "codes", "lengths")]
    kw = dict(chunk_size=c["chunk"], coding=c["coding"])
    before = ops.LAUNCHES["symlen_pack"]
    got = ef.symlen_pack(*args, **kw)
    assert ops.LAUNCHES["symlen_pack"] == before + 1
    want = ef.symlen_pack_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


LEVEL_SHAPES = [(n, e, wp) for n, e in PAIRS for wp in widths(n, e)]
K5_SHAPES = [(n, e, w) for n, e in PAIRS for w in widths(n, e)]


def _layout_quant(c, cuda):
    from repro_torch.core.quantize import quant_table_from_arrays

    return quant_table_from_arrays(c["zone"], c["scale"], c["mu"],
                                   c["alpha1"]).to(cuda)


def _layout_bases(n, e, cuda):
    return [("identity", torch.eye(n, device=cuda)[:, :e].contiguous()),
            ("dct", dct.dct_basis(n, e, device=cuda))]


def assert_levels_rule(got, want, got_levels, want_levels, exact):
    """Outputs of encode_levels (grid, zrow, zcol, ncoded) against the plain
    version's: all equal when ``exact`` (the identity basis); else the flip
    rule on the levels before prediction, and every output equal on the
    rows with no flipped level."""
    if exact:
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            assert g is None or (g.dtype == w.dtype and torch.equal(g, w))
        return
    assert_flip_rule(got_levels, want_levels)
    clean = (got_levels == want_levels).reshape(got_levels.shape[0], -1).all(
        dim=1)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        assert g is None or torch.equal(g[clean], w[clean])


@pytest.mark.parametrize("coding", LEVEL_CODINGS,
                         ids=lambda c: "-".join(str(v) for v in c))
@pytest.mark.parametrize("shape", LEVEL_SHAPES,
                         ids=lambda s: "n{}-e{}-w{}".format(*s))
def test_encode_levels_kernel_on_layouts(cuda, shape, coding):
    """encode_levels and its gather arm on the layouts of
    tests/_levels_layouts.py, with enough rows that every persistent CTA
    walks more than 4 tiles: the identity basis exactly, the DCT basis by
    the flip rule; the gather arm equal to the dense arm on the gathered
    rows bit for bit, and (identity basis) to its plain version."""
    n, e, wp = shape
    c = levels_case(n, e, wp, coding, rows=walk_rows(n, e, wp))
    q = _layout_quant(c, cuda)
    x, counts, flat, st, ln, gcounts = (
        torch.from_numpy(c[f]).to(cuda) for f in (
            "signals", "counts", "flat", "starts", "lens", "gcounts"))
    rows = ef.gather_rows(flat, st, ln, c["width"])
    kw = dict(n=n, e=e, coding=c["coding"])
    for name, basis in _layout_bases(n, e, cuda):
        before = dict(ops.LAUNCHES)
        got = ef.encode_levels(x, counts, q, basis, **kw)
        gg = ef.encode_levels_gather(flat, st, ln, gcounts, q, basis,
                                     width=c["width"], **kw)
        assert ops.LAUNCHES["encode_levels"] == before["encode_levels"] + 1
        assert ops.LAUNCHES["encode_levels_gather"] == (
            before["encode_levels_gather"] + 1)
        want = ef.encode_levels_plain(x, counts, q, basis, **kw)
        levels = ef.encode_levels(x, counts, q, basis, n=n, e=e)[0]
        plain_levels = ef.encode_levels_plain(x, counts, q, basis, n=n,
                                              e=e)[0]
        assert_levels_rule(got, want, levels, plain_levels,
                           name == "identity")
        dense = ef.encode_levels(rows, gcounts, q, basis, **kw)
        torch.cuda.synchronize()
        for g, d in zip(gg, dense):
            assert (g is None) == (d is None)
            assert g is None or (g.dtype == d.dtype and torch.equal(g, d))
        if name == "identity":
            gp = ef.encode_levels_gather_plain(flat, st, ln, gcounts, q,
                                               basis, width=c["width"], **kw)
            assert_levels_rule(gg, gp, None, None, True)


@pytest.mark.parametrize("shape", K5_SHAPES,
                         ids=lambda s: "n{}-e{}-w{}".format(*s))
def test_k5_kernel_on_layouts(cuda, shape):
    """dct_quant on the (N, E) pairs of tests/_levels_layouts.py at window
    counts of 1, a block less and more 1 and 8192 + 3, from an aligned
    start, one window on (not 16-byte aligned for N % 4 != 0) and one
    sample on (never aligned): the identity basis exactly, the DCT basis
    by the flip rule."""
    n, e, w = shape
    c = dct_case(n, e, w)
    q = _layout_quant(c, cuda)
    full = torch.from_numpy(c["windows"]).to(cuda)
    one = full.reshape(-1)[1:1 + w * n].view(w, n)  # one sample on
    for x in (full[:w], full[1:], one):
        for name, basis in _layout_bases(n, e, cuda):
            before = ops.LAUNCHES["dct_quant"]
            got = dq.dct_quant(x, q, e=e, basis=basis)
            assert ops.LAUNCHES["dct_quant"] == before + 1
            want = dq.dct_quant_plain(x, q, basis)
            torch.cuda.synchronize()
            if name == "identity":
                assert torch.equal(got, want)
            else:
                assert_flip_rule(got, want)


IDCT_SHAPES = [(e, n, w) for e, n in IDCT_PAIRS for w in idct_widths(e, n)]


def _idct_runs(kernel, c, cuda):
    """(the wrapper on some levels, its plain version) for one layout."""
    basis = torch.from_numpy(c["basis"]).to(cuda)
    if kernel == "lut_idct":
        lut = torch.from_numpy(c["lut"]).to(cuda)
        return (lambda lv: df.lut_idct(lv, lut, basis),
                lambda lv: df.lut_idct_plain(lv, lut, basis))
    q = _layout_quant(c, cuda)
    return (lambda lv: idq.idct_dequant(lv, q, basis),
            lambda lv: idq.idct_dequant_plain(lv, q, basis))


@pytest.mark.parametrize("shape", IDCT_SHAPES,
                         ids=lambda s: "e{}-n{}-w{}".format(*s))
@pytest.mark.parametrize("kernel", ["lut_idct", "idct_dequant"])
def test_idct_kernels_on_layouts(cuda, kernel, shape):
    """lut_idct and K3 on the layouts of tests/_idct_layouts.py (1 window,
    less than a tile, one past a multiple of it, and enough tiles that every
    persistent CTA walks more than 4): against the plain version within the
    float bound, and from a levels base at each byte offset 1-15 equal bit
    for bit to the aligned run."""
    e, n, w = shape
    c = idct_case(e, n, w)
    run, plain = _idct_runs(kernel, c, cuda)
    levels = torch.from_numpy(c["levels"]).to(cuda)
    before = ops.LAUNCHES[kernel]
    got = run(levels)
    assert ops.LAUNCHES[kernel] == before + 1
    assert_close(got, plain(levels))
    flat = levels.reshape(-1)
    buf = torch.empty(flat.numel() + 16, dtype=torch.uint8, device=cuda)
    for off in range(1, 16):
        buf[off:off + flat.numel()] = flat
        lv = buf[off:off + flat.numel()].view(w, e)
        assert lv.data_ptr() % 16 == off
        assert torch.equal(run(lv), got)


@pytest.mark.parametrize("pair", IDCT_PAIRS,
                         ids=lambda p: "e{}-n{}".format(*p))
def test_idct_kernels_every_level(cuda, pair):
    """Every level in every band (levels [256, E], basis [I_E | 0]), so the
    output's first E columns are the dequant table: lut_idct's equal to the
    LUT (transposed) exactly, K3's to the plain dequantize within the float
    bound; the other columns zero."""
    from repro_torch.core.quantize import dequantize

    e, n = pair
    c = idct_case(e, n, 1)
    levels, eye = (torch.from_numpy(a).to(cuda) for a in every_level(e, n))
    lut = torch.from_numpy(c["lut"]).to(cuda)
    got = df.lut_idct(levels, lut, eye)
    assert torch.equal(got[:, :e], lut.T)
    assert not got[:, e:].any()
    q = _layout_quant(c, cuda)
    got = idq.idct_dequant(levels, q, eye)
    assert_close(got[:, :e].contiguous(), dequantize(levels, q))
    assert not got[:, e:].any()


SYMLEN_CASES = [(l_max, layout) for l_max in L_MAXES
                for layout in SYMLEN_LAYOUTS]


def _symlen_tables(lengths, l_max, cuda):
    from repro_torch.core.calibration import DomainTables
    from repro_torch.core.config import CodecConfig
    from repro_torch.core.huffman import codebook_from_lengths
    from repro_torch.core.quantize import quant_table_from_arrays

    return DomainTables(
        config=CodecConfig(n=8, e=8, b1=0, b2=8, l_max=l_max),
        quant=quant_table_from_arrays(np.zeros(8), np.ones(8), 50.0, 0.0),
        book=codebook_from_lengths(lengths, l_max),
    ).device_tables(cuda)


def _symlen_inputs(c, cuda):
    """(words, symlen) on the card as they are, and as views at an odd
    offset of larger buffers."""
    w = torch.from_numpy(c["words"].view(np.int64)).to(cuda)
    s = torch.from_numpy(c["symlen"]).to(cuda)
    n = w.numel()
    wbuf = torch.zeros(n + 3, dtype=torch.int64, device=cuda)
    sbuf = torch.zeros(n + 5, dtype=torch.uint8, device=cuda)
    wbuf[1:n + 1] = w
    sbuf[3:n + 3] = s
    return [(w, s), (wbuf[1:n + 1], sbuf[3:n + 3])]


@pytest.mark.parametrize("case", SYMLEN_CASES,
                         ids=lambda c: "l{}-{}".format(*c))
def test_k1_kernel_on_symlen_layouts(cuda, case):
    """K1 on the layouts of tests/_symlen_layouts.py (word counts around a
    tile and enough that every persistent CTA walks more than 4 tiles;
    num_symbols below, at and past the total; aligned and odd-offset
    inputs): every output byte equal to the plain version, written over a
    buffer of garbage (the kernel writes its zeros itself)."""
    l_max, layout = case
    for count in (*SYMLEN_COUNTS, SYMLEN_BIG):
        c = symlen_case(l_max, layout, count)
        tables = _symlen_tables(c["lengths"], l_max, cuda)
        for w, s in _symlen_inputs(c, cuda):
            for nsym in num_symbols_cases(c["total"]):
                kw = dict(l_max=l_max, max_symlen=c["max_symlen"],
                          num_symbols=nsym)
                want = hd.huffman_decode_plain(w, s, tables, **kw)
                junk = torch.full((nsym,), 0xA5, dtype=torch.uint8,
                                  device=cuda)
                del junk  # its block is the next allocation of this size
                before = ops.LAUNCHES["symlen_decode"]
                got = hd.huffman_decode_dense(w, s, tables, **kw)
                assert ops.LAUNCHES["symlen_decode"] == before + 1
                torch.cuda.synchronize()
                assert torch.equal(got, want), (count, nsym)


@pytest.mark.parametrize("case", SYMLEN_CASES,
                         ids=lambda c: "l{}-{}".format(*c))
def test_k6_kernel_on_symlen_layouts(cuda, case):
    """K6 on the same layouts: the whole tile equal to the plain version,
    and compacted equal to K1's dense output."""
    l_max, layout = case
    for count in (*SYMLEN_COUNTS, SYMLEN_BIG):
        c = symlen_case(l_max, layout, count)
        tables = _symlen_tables(c["lengths"], l_max, cuda)
        kw = dict(l_max=l_max, max_symlen=c["max_symlen"])
        for w, s in _symlen_inputs(c, cuda):
            before = ops.LAUNCHES["symlen_tile"]
            got = hd.huffman_decode_tile(w, tables, **kw)
            assert ops.LAUNCHES["symlen_tile"] == before + 1
            want = hd.huffman_decode_tile_plain(w, tables, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), count
            nsym = max(1, c["total"])
            dense = compact_padded_scatter(got.T, s, nsym)
            k1 = hd.huffman_decode_dense(w, s, tables, num_symbols=nsym, **kw)
            assert torch.equal(dense.to(torch.uint8), k1), count


def test_k1_threads_sharing_the_default_stream(cuda):
    """Two host threads decoding different codebooks on the default stream
    at once, with no synchronization between calls: K1's two launches of a
    call share one workspace a stream, so a call's launches must not
    interleave with another thread's.  Every output equal to the plain
    version."""
    import threading

    cases = []
    for l_max, layout in ((8, "stream"), (12, "random")):
        c = symlen_case(l_max, layout, 40 * SYMLEN_COUNTS[1] + 3)
        tables = _symlen_tables(c["lengths"], l_max, cuda)
        w, s = _symlen_inputs(c, cuda)[0]
        kw = dict(l_max=l_max, max_symlen=c["max_symlen"],
                  num_symbols=c["total"] + 5)
        cases.append((w, s, tables, kw,
                      hd.huffman_decode_plain(w, s, tables, **kw)))
    calls = 500
    start = threading.Barrier(len(cases))
    outs = [[] for _ in cases]
    streams = [None] * len(cases)

    def run(i):
        w, s, tables, kw, _ = cases[i]
        streams[i] = torch.cuda.current_stream(cuda)
        start.wait()
        for _ in range(calls):
            outs[i].append(hd.huffman_decode_dense(w, s, tables, **kw))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for i, (*_, want) in enumerate(cases):
        assert streams[i] == torch.cuda.default_stream(cuda)
        assert len(outs[i]) == calls
        bad = [j for j, got in enumerate(outs[i])
               if not torch.equal(got, want)]
        assert not bad, (i, bad[:10])


@pytest.mark.parametrize("l_max", range(1, 17))
def test_decode_lut_on_card(cuda, l_max):
    """The decode table built on the card (by K1's first kernel) equal to
    the plain table, entry by entry, for codes of three kinds."""
    for layout in ("stream", "one_bit", "random"):
        lengths = symlen_case(l_max, layout, 1)["lengths"]
        tables = _symlen_tables(lengths, l_max, cuda)
        before = ops.LAUNCHES["symlen_lut"]
        got = hd.decode_lut(tables, l_max=l_max)
        assert ops.LAUNCHES["symlen_lut"] == before + 1
        want = hd.decode_lut_plain(tables, l_max=l_max)
        assert got.dtype == torch.int16 and torch.equal(got, want)


def test_encode_engine_on_card_matches_cpu(cuda):
    """The encode slice on the card: ``BatchEncoder()`` (the card by
    default) against the same engine on the CPU, in chunked and exact mode,
    with the launch counters showing the kernels ran.  A signal whose
    levels the card quantizes exactly as the CPU gives equal bytes; the
    others (flips, by the rule above) decode equal outside the flipped
    windows."""
    specs = [("biomedical", "mitbih"), ("power", "load_power")]
    tables, sigs, doms = {}, [], []
    for j, coding in enumerate(CODINGS[::2]):
        for d, (dom, ds) in enumerate(specs):
            did = 2 * j + d
            tables[did] = _tables(dom, ds, coding, domain_id=did)
            for i, n in enumerate((5000, 777)):
                sigs.append(make_signal(ds, n, seed=300 + did * 2 + i))
                doms.append(did)
            # an empty, a one-sample and a sub-window signal
            sigs += [np.zeros(0, np.float32), np.ones(1, np.float32),
                     make_signal(ds, 33, seed=400 + did)]
            doms += [did] * 3
    for chunk in (1024, None):
        ops.reset_launches()
        enc = BatchEncoder(chunk_size=chunk)
        assert enc.device.type == "cuda"
        got = enc.encode(sigs, tables, domain_ids=doms).to_host()
        buckets = enc.stats.dispatches
        assert ops.LAUNCHES["encode_levels"] == buckets
        assert ops.LAUNCHES["symlen_pack"] == buckets
        want = BatchEncoder(chunk_size=chunk, device="cpu").encode(
            sigs, tables, domain_ids=doms).to_host()
        dec = BatchDecoder(device="cpu")
        for g, w, s, d in zip(got, want, sigs, doms):
            cfg = tables[d].config
            win = torch.from_numpy(np.pad(s, (0, -len(s) % cfg.n))).reshape(
                -1, cfg.n)
            q = tables[d].quant
            basis = dct.dct_basis(cfg.n, cfg.e)
            lk = dq.dct_quant(win.to(cuda), q.to(cuda), e=cfg.e,
                              basis=basis.to(cuda)).cpu()
            lp = dq.dct_quant_plain(win, q, basis)
            assert_flip_rule(lk, lp)
            same = (lk == lp).all(dim=1).numpy()
            if same.all():
                assert g.to_bytes() == w.to_bytes()
            a, b = dec.decode([g, w], tables[d]).to_host()
            keep = np.repeat(same, cfg.n)[: len(s)]
            np.testing.assert_array_equal(a[keep], b[keep])
        enc.close()
    one = codec.encode_device(sigs[0], tables[doms[0]])
    assert one.to_bytes() == codec.encode(sigs[0], tables[doms[0]]).to_bytes()
    # the fixed-rate encode on the card, with K5
    kv = _tables("kv", "mitbih", {})
    x = _kv_windows(cuda, 64, 4 * kv.config.n, seed=5).reshape(4, 16, -1)
    before = ops.LAUNCHES["dct_quant"]
    lv = BatchEncoder().encode_fixed(x, kv)
    assert ops.LAUNCHES["dct_quant"] == before + 1
    assert lv.device.type == "cuda" and lv.shape == (4, 16, 4, kv.config.e)
    assert_flip_rule(lv.cpu(), BatchEncoder(device="cpu").encode_fixed(
        x.cpu(), kv))


# ---------------------------------------------------------------------------
# The transcoder on the card.
# ---------------------------------------------------------------------------
def test_transcode_on_card_matches_round_trip(cuda):
    """A mixed v2/v3 archive transcoded on the card, each domain to its twin
    coding: byte for byte the card's own round trip (decode to the host,
    then encode), with no host sync inside ``transcode()``
    (``torch.cuda.set_sync_debug_mode("error")``), the gather kernel and no
    dense ``encode_levels`` on the encode side; then an EncodedBatch source
    (v2 -> v3, consumed)."""
    specs = [("biomedical", "mitbih"), ("power", "load_power")]
    tables, archive, dst_ids = {}, [], []
    for j, coding in enumerate(CODINGS[:3:2]):  # v2 and v3 (delta)
        for d, (dom, ds) in enumerate(specs):
            did = 2 * j + d
            tables[did] = _tables(dom, ds, coding, domain_id=did)
    for did in range(2):
        for i, n in enumerate((5000, 777, 33)):
            sig = make_signal(specs[did][1], n, seed=500 + 2 * did + i)
            for src in (did, did + 2):
                archive.append(codec.encode(sig, tables[src]))
                dst_ids.append(src + 2 if src < 2 else src - 2)
    dec, enc = BatchDecoder(), BatchEncoder()
    tc = Transcoder(decoder=dec, encoder=enc)
    want = enc.encode(dec.decode(archive, tables).to_host(), tables,
                      domain_ids=dst_ids).to_host()
    tc.transcode(archive, tables, tables, dst_domain_ids=dst_ids).to_host()
    torch.cuda.synchronize()
    ops.reset_launches()
    buckets = enc.stats.dispatches
    torch.cuda.set_sync_debug_mode("error")
    try:
        batch = tc.transcode(archive, tables, tables, dst_domain_ids=dst_ids)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = batch.to_host()
    assert [g.to_bytes() for g in got] == [w.to_bytes() for w in want]
    assert ops.LAUNCHES["encode_levels"] == 0
    buckets = enc.stats.dispatches - buckets
    assert buckets >= len(tables)
    assert ops.LAUNCHES["encode_levels_gather"] == buckets
    assert ops.LAUNCHES["symlen_pack"] == ops.LAUNCHES["encode_levels_gather"]
    assert ops.LAUNCHES["symlen_decode"] == len(tables)
    # an EncodedBatch source: v2 -> v3 without a drain
    sigs = [make_signal("load_power", n, seed=600 + i)
            for i, n in enumerate((4096, 1000))]
    src = enc.encode(sigs, tables[1])
    drained = enc.encode(sigs, tables[1]).to_host()
    out = tc.transcode(src, tables[1], tables[3]).to_host()
    assert [o.to_bytes() for o in out] == [
        o.to_bytes() for o in tc.transcode(drained, tables[1],
                                           tables[3]).to_host()]
    with pytest.raises(RuntimeError, match="donated"):
        src.to_host()
    tc.close()


# ---------------------------------------------------------------------------
# The serving frontend on the card.
# ---------------------------------------------------------------------------
def _serving_tables():
    """Two serving domains with different configs (power e = 6,
    meteorological e = 8), so a flipped domain id lands on plan-mismatch;
    plus a v3 power table for the v3-only corruption."""
    from repro_torch.serving import DOMAIN_DATASETS

    tables = {}
    for domain_id in (2, 3):
        domain, dataset = DOMAIN_DATASETS[domain_id]
        tables[domain_id] = calibrate(
            make_signal(dataset, 32768, seed=1000 + domain_id),
            DOMAIN_DEFAULTS[domain], domain_id=domain_id)
    v3 = calibrate(make_signal("load_power", 32768, seed=1002),
                   DOMAIN_DEFAULTS["power"].replace(**CODINGS[2]),
                   domain_id=2)
    return tables, v3


def _serve_stream(tables, seed, rate=300.0):
    from repro_torch.serving import TrafficConfig, generate

    return generate(TrafficConfig(
        rate=rate, duration_s=0.5, fixed_windows=8,
        mix={"decode": 0.5, "encode": 0.3, "transcode": 0.2},
        domains=(2, 3), seed=seed), tables)


def _submit(fe, r):
    if r.kind == "decode":
        return fe.submit_decode(r.container)
    if r.kind == "encode":
        return fe.submit_encode(r.signal, r.domain_id)
    return fe.submit_transcode(r.container, r.dst_domain_id)


def _same(got, want):
    if isinstance(want, bytes):
        return got.to_bytes() == want
    return got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_frontend_on_card_byte_identical_with_poison(cuda):
    """``ServingFrontend(tables)`` with no device serves on the card: mixed
    decode / encode / transcode requests, plus one corrupt blob per
    ``CONTAINER_FAULTS`` class among them, each clean response equal to
    the offline engines on the card (samples bit for bit, containers byte
    for byte), each corrupt one a typed outcome of its expected class, and
    every kernel of the served path launched."""
    from repro_torch.core.container import ContainerFormatError
    from repro_torch.serving import (
        FrontendConfig,
        PoisonedContainerError,
        ServingFrontend,
    )
    from repro_torch.testing.faults import (
        CONTAINER_FAULTS,
        EXPECTED_FAULT,
        corrupt,
        offline_expected,
    )

    tables, v3 = _serving_tables()
    reqs = _serve_stream(tables, seed=11)
    want = offline_expected(reqs, tables)
    blob = next(r.container for r in reqs
                if r.container is not None).to_bytes()
    blob_v3 = codec.encode(make_signal("load_power", 256, seed=3),
                           v3).to_bytes()
    ops.reset_launches()
    with ServingFrontend(tables, config=FrontendConfig(
            max_batch=16, default_slo_ms=60_000.0)) as fe:
        assert fe.decoder.device.type == "cuda"
        futs = [_submit(fe, r) for r in reqs]
        poison = {}
        for fault in CONTAINER_FAULTS:
            src = blob_v3 if fault == "reserved-flags" else blob
            try:
                poison[fault] = fe.submit_decode(corrupt(src, fault, seed=13))
            except ContainerFormatError as err:  # typed at admission
                poison[fault] = err
        fe.flush()
        got = [f.result(timeout=120) for f in futs]
        for fault, f in poison.items():
            err = f
            if not isinstance(f, Exception):
                with pytest.raises(PoisonedContainerError) as exc:
                    f.result(timeout=120)
                err = exc.value
            assert err.fault in EXPECTED_FAULT[fault], (fault, err)
    bad = [i for i, g in enumerate(got) if not _same(g, want[i])]
    assert not bad, bad[:10]
    for name in ("symlen_decode", "lut_idct", "encode_levels",
                 "encode_levels_gather", "symlen_pack"):
        assert ops.LAUNCHES[name] > 0, name


def test_two_frontend_dispatchers_share_the_default_stream(cuda):
    """Two frontends, each with its own engines and dispatcher thread,
    serving at once on the card's default stream: the kernels' shared
    state (K1's workspace, the launch counters) is taken under locks, so
    every response equals the offline engines' and the counters add up to
    both frontends' bucket counts."""
    import threading

    from repro_torch.serving import FrontendConfig, ServingFrontend
    from repro_torch.testing.faults import offline_expected

    tables, _ = _serving_tables()
    streams = [_serve_stream(tables, seed=21 + i, rate=600.0)
               for i in range(2)]
    wants = [offline_expected(reqs, tables) for reqs in streams]
    torch.cuda.synchronize()
    ops.reset_launches()
    fes = [ServingFrontend(tables, config=FrontendConfig(
        max_batch=4, default_slo_ms=60_000.0)) for _ in streams]
    outs = [None, None]
    start = threading.Barrier(2)

    def drive(i):
        start.wait(30)
        futs = [_submit(fes[i], r) for r in streams[i]]
        fes[i].flush()
        outs[i] = [f.result(timeout=120) for f in futs]

    threads = [threading.Thread(target=drive, args=(i,)) for i in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        for fe in fes:
            fe.close()
    assert not any(t.is_alive() for t in threads)
    for i in range(2):
        bad = [j for j, g in enumerate(outs[i])
               if not _same(g, wants[i][j])]
        assert not bad, (i, bad[:10])
    dec = sum(fe.decoder.stats.dispatches for fe in fes)
    enc = sum(fe.encoder.stats.dispatches for fe in fes)
    assert ops.LAUNCHES["symlen_decode"] == ops.LAUNCHES["lut_idct"] == dec
    assert ops.LAUNCHES["symlen_pack"] == enc > 0
    assert (ops.LAUNCHES["encode_levels"]
            + ops.LAUNCHES["encode_levels_gather"]) == enc


# ---------------------------------------------------------------------------
# The workloads (M8) on the card: the KV codec (K5, then K3) and a
# compressed train-state checkpoint at n = e = 64, l_max = 12 (K4 to save,
# K1 + lut_idct to restore).
# ---------------------------------------------------------------------------
def _kv_block(cuda, dtype, b=2, t=256, h=4, d=16, seed=0):
    """A walk along the token axis per channel, [B, T, H, D] on the card."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.standard_normal((b, t, h, d)), axis=1) * (
        4.0 / t ** 0.5)
    return torch.from_numpy(walk.astype(np.float32)).to(cuda, dtype)


def test_kv_zero_host_bounces(cuda):
    """Compress + decompress under ``set_sync_debug_mode("error")``: after
    one warm call the codec never waits for the card, and each call is one
    K5 and one K3 launch."""
    from repro_torch.serving import KVCacheCodec

    kv = _kv_block(cuda, torch.bfloat16)
    codec = KVCacheCodec()
    assert codec.encoder.device.type == codec.decoder.device.type == "cuda"
    codec.calibrate(kv, layer="l0")
    codec.decompress(codec.compress(kv, layer="l0"), layer="l0")  # warm
    torch.cuda.synchronize()
    before = dict(ops.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ckv = codec.compress(kv, layer="l0")
        out = codec.decompress(ckv, layer="l0")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    moved = {k: ops.LAUNCHES[k] - before[k] for k in before}
    assert moved == {k: int(k in ("dct_quant", "idct_dequant"))
                     for k in before}
    assert out.shape == kv.shape and out.dtype == kv.dtype
    assert out.is_cuda and out.is_contiguous()
    rel = float(torch.linalg.vector_norm((out - kv).float())
                / torch.linalg.vector_norm(kv.float()))
    assert rel < 0.05, rel


def test_kv_codec_matches_plain(cuda):
    """The codec's levels against K5's plain version on its channel strips
    (the flip rule), its reconstruction against K3's plain version of those
    levels, transposed back (within the float bound)."""
    from repro_torch.serving import KVCacheCodec

    kv = _kv_block(cuda, torch.float32, seed=1)
    codec = KVCacheCodec()
    tab = codec.calibrate(kv)
    n, e = tab.config.n, tab.config.e
    ckv = codec.compress(kv)
    strips = kv.movedim(1, -1).contiguous()
    assert torch.equal(codec.channel_strips(kv), strips)
    plan = codec.encoder.plan_for(tab)
    want = dq.dct_quant_plain(strips.reshape(-1, n), plan.tables.quant,
                              plan.basis)
    assert_flip_rule(ckv.levels.reshape(-1, e), want)
    out = codec.decompress(ckv)
    plain = idq.idct_dequant_plain(ckv.levels.reshape(-1, e),
                                   plan.tables.quant,
                                   dct.idct_basis(n, e, device=cuda))
    assert_close(out, plain.reshape(strips.shape).movedim(-1, 1))


def _recording(monkeypatch, calls):
    """Record every call of the train-state path's four kernel wrappers
    (inputs cloned before, output after), as chip_smoke's phases do; the
    launch shape (``rw``) is the kernel's alone, so the record keeps the
    plain version's arguments."""
    def snap(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        return tuple(map(snap, x)) if isinstance(x, tuple) else x

    for mod, attr in ((ef, "encode_levels"), (ef, "symlen_pack"),
                      (hd, "huffman_decode_dense"), (df, "lut_idct")):
        fn = getattr(mod, attr)

        def rec(*args, _fn=fn, _name=attr, **kw):
            ins = (snap(args),
                   {k: snap(v) for k, v in kw.items() if k != "rw"})
            out = _fn(*args, **kw)
            calls.setdefault(_name, []).append((*ins, snap(out)))
            return out

        monkeypatch.setattr(mod, attr, rec)


def test_train_state_checkpoint_on_card(cuda, tmp_path, monkeypatch):
    """A small train state through ``save_checkpoint(compress=True)`` and
    ``restore_latest`` on the card, at the checkpoint's n = e = 64 and
    l_max = 12 with 1024-symbol chunks: one ``encode_levels`` +
    ``symlen_pack`` per encode bucket, one ``symlen_decode`` + ``lut_idct``
    per decode bucket, every call held to its plain version (levels by the
    flip rule, the pack and K1 exactly, ``lut_idct`` within the float
    bound), every leaf within relative rms 0.02 on the card, and equal to
    the CPU's restore of the same blob within the float bound."""
    from repro_torch.distributed import checkpoint as ckpt

    rng = np.random.default_rng(7)

    def walk(shape, scale):
        t = np.cumsum(rng.standard_normal(shape), axis=0).astype(np.float32)
        return torch.from_numpy(t / np.abs(t).max() * scale).to(cuda)

    tree = {
        "p": {"w": torch.from_numpy(rng.standard_normal(
            (512, 320)).astype(np.float32) * np.float32(0.02)).to(cuda),
              "norm": 1.0 + walk((4096,), 0.1)},
        "m": {"w": walk((512, 320), 1e-3)},
        "v": {"w": walk((512, 320), 1e-6)},
        "step": torch.tensor(3, dtype=torch.int32, device=cuda),
    }
    calls = {}
    _recording(monkeypatch, calls)
    before = dict(ops.LAUNCHES)
    path = ckpt.save_checkpoint(str(tmp_path), 1, tree, compress=True)
    saved = {k: ops.LAUNCHES[k] - before[k] for k in before}
    manifest = json.load(open(f"{path}/manifest.json"))
    lengths = [n for leaf in manifest["state"]["leaves"]
               for n in leaf["lengths"]]
    enc_buckets = len({p2(-(-n // 64)) for n in lengths})
    assert saved["encode_levels"] == saved["symlen_pack"] == enc_buckets
    before = dict(ops.LAUNCHES)
    step, got = ckpt.restore_latest(str(tmp_path), tree)
    restored = {k: ops.LAUNCHES[k] - before[k] for k in before}
    assert step == 1
    assert restored["symlen_decode"] == restored["lut_idct"] == 1
    for name, rows in calls.items():
        assert len(rows) == (saved if name.startswith(("encode", "symlen_p"))
                             else restored)[
            "symlen_decode" if name == "huffman_decode_dense" else name]
        for args, kw, out in rows:
            if name == "encode_levels":
                assert kw["n"] == kw["e"] == 64
                want = ef.encode_levels_plain(*args, **kw)
                assert_flip_rule(out[0], want[0])
            elif name == "symlen_pack":
                assert kw["chunk_size"] == 1024
                want = ef.symlen_pack_plain(*args, **kw)
                assert all(torch.equal(g, w) for g, w in zip(out, want))
            elif name == "huffman_decode_dense":
                assert kw["l_max"] == 12
                assert torch.equal(out, hd.huffman_decode_plain(*args, **kw))
            else:
                assert args[0].shape[1] == args[2].shape[1] == 64
                assert_close(out, df.lut_idct_plain(*args, **kw))
    _, host = ckpt.restore_latest(str(tmp_path), tree, device="cpu")
    for key in (("p", "w"), ("p", "norm"), ("m", "w"), ("v", "w")):
        a, b, c = tree[key[0]][key[1]], got[key[0]][key[1]], host[
            key[0]][key[1]]
        assert b.is_cuda and b.dtype == a.dtype and b.shape == a.shape
        rel = float(torch.linalg.vector_norm(b - a)
                    / torch.linalg.vector_norm(a))
        assert rel < 0.02, (key, rel)
        assert_close(b, c)
    assert int(got["step"]) == 3 and got["step"].is_cuda


# ---------------------------------------------------------------------------
# Tuning (M9) and shards (M3b) on the card.
# ---------------------------------------------------------------------------
def _tuning_archive(seed=500):
    """A v2 and a v3 archive slice of two domains: (containers, signals,
    domain ids, tables)."""
    specs = [("biomedical", "mitbih"), ("power", "load_power")]
    tables, cs, sigs, doms = {}, [], [], []
    for j, coding in enumerate((CODINGS[0], CODINGS[4])):
        for d, (dom, ds) in enumerate(specs):
            did = 2 * j + d
            tables[did] = _tables(dom, ds, coding, domain_id=did)
            for i, n in enumerate((9000, 4100, 777)):
                sig = make_signal(ds, n, seed=seed + 4 * did + i)
                sigs.append(sig)
                doms.append(did)
                cs.append(Container.from_bytes(
                    codec.encode(sig, tables[did]).to_bytes()))
    return cs, sigs, doms, tables


def test_tile_rules_match_the_launchers(cuda):
    """``kernels/tiles.py``'s copy of the launchers' tile rules (what the
    cost model charges and the CPU's tests use) equals the built
    library's at every (E, N) from 1 to 128 and every register tile, the
    refused ones included, and the v3 stage's at every E and tile."""
    from repro_torch.kernels import tiles

    optin = torch.cuda.get_device_properties(
        cuda).shared_memory_per_block_optin
    for e in range(1, 129):
        for n in range(1, 129):
            for rw in (0, 2, 4, 8):
                assert tiles.launcher_idct_tile(e, n, rw, optin) == (
                    tiles.idct_tile_shape(e, n, rw, optin)), (e, n, rw)
            for rw in (0, 1, 2, 3, 4, 8):
                assert tiles.launcher_dct_tile(n, e, rw) == (
                    tiles.dct_tile_shape(n, e, rw)), (n, e, rw)
        for t in (*range(-256, 4097, 128), 300):
            assert tiles.launcher_v3_tile_ok(t, e) == tiles.v3_tile_ok(t, e)
    # the pick at the H100's opt-in maximum, which the cost model charges
    assert tiles.launcher_idct_tile(16, 32) == tiles.idct_tile_shape(16, 32)


def test_forced_launch_shapes_match_the_pick(cuda):
    """Every launch shape a launcher accepts gives the outputs of its own
    pick (0), bit for bit: ``lut_idct`` at rw 4 and 8, ``encode_levels``
    and its gather arm at every legal rw, the v3 stage at every offered
    tile, and the whole bucket decode and encode with the shapes pinned."""
    from repro_torch.kernels import tiles
    from repro_torch.tuning import autotune

    for e, n in ((6, 32), (32, 32), (64, 64), (128, 128)):
        c = idct_case(e, n, 3 * tiles.idct_tile_shape(e, n).bw + 5, seed=1)
        lv = torch.from_numpy(c["levels"]).to(cuda)
        lut = torch.from_numpy(c["lut"]).to(cuda)
        basis = torch.from_numpy(c["basis"]).to(cuda)
        want = df.lut_idct(lv, lut, basis)
        for rw in tiles.idct_rws(e, n):
            assert torch.equal(df.lut_idct(lv, lut, basis, rw=rw), want)
    _, _, _, tables = _tuning_archive()
    for did, tab in tables.items():
        cfg = tab.config
        dec_in = autotune.decode_bucket_inputs(
            tab, num_words=2048, num_windows=1024, device=cuda)
        want = df.decode_fused(*dec_in["args"], **dec_in["kw"], idct_rw=0,
                               v3_tile_windows=0)
        for blocks in autotune.decode_block_candidates(cfg.n, cfg.e,
                                                       cfg.coding):
            got = df.decode_fused(
                *dec_in["args"], **dec_in["kw"], idct_rw=blocks["idct_rw"],
                v3_tile_windows=blocks.get("v3_tile_windows", 0))
            assert torch.equal(got, want), (did, blocks)
        enc_in = autotune.encode_bucket_inputs(
            tab, rows=16, num_windows=300, chunk_size=1024, device=cuda)
        x, counts, dt, basis = enc_in["args"]
        kw = dict(n=cfg.n, e=cfg.e, coding=cfg.coding)
        want = ef.encode_levels(x, counts, dt.quant, basis, **kw)
        width = x.shape[1]
        flat = torch.cat([x.reshape(-1), torch.zeros(width, device=cuda)])
        st = torch.arange(16, dtype=torch.int32, device=cuda) * width
        ln = torch.full((16,), width - 7, dtype=torch.int32, device=cuda)
        gwant = ef.encode_levels_gather(flat, st, ln, counts, dt.quant,
                                        basis, width=width, **kw)
        whole = ef.encode_fused(*enc_in["args"], **enc_in["kw"],
                                levels_rw=0)
        for b in autotune.encode_block_candidates(cfg.n, cfg.e):
            rw = b["levels_rw"]
            got = ef.encode_levels(x, counts, dt.quant, basis, rw=rw, **kw)
            assert all((g is None and w is None) or torch.equal(g, w)
                       for g, w in zip(got, want)), (did, rw)
            got = ef.encode_levels_gather(flat, st, ln, counts, dt.quant,
                                          basis, width=width, rw=rw, **kw)
            assert all((g is None and w is None) or torch.equal(g, w)
                       for g, w in zip(got, gwant)), (did, rw)
            got = ef.encode_fused(*enc_in["args"], **enc_in["kw"],
                                  levels_rw=rw)
            assert all((g is None and w is None) or torch.equal(g, w)
                       for g, w in zip(got, whole)), (did, rw)


def test_illegal_launch_shapes_raise(cuda):
    """A launch shape the launcher refuses fails the launch with an error:
    nothing is clamped."""
    lv = torch.zeros(300, 128, dtype=torch.uint8, device=cuda)
    lut = torch.zeros(128, 256, device=cuda)
    basis = torch.zeros(128, 128, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        df.lut_idct(lv, lut, basis, rw=8)  # the buffers do not fit
    with pytest.raises(RuntimeError, match="launch failed"):
        df.lut_idct(lv[:, :6], lut[:6], basis[:6, :32].contiguous(), rw=3)
    tab = _tables("power", "load_power", {})
    cfg = tab.config
    x = torch.zeros(2, 64 * cfg.n, device=cuda)
    counts = torch.full((2,), 64 * cfg.e, dtype=torch.int32, device=cuda)
    q = tab.quant.to(cuda)
    b = dct.dct_basis(cfg.n, cfg.e).to(cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        ef.encode_levels(x, counts, q, b, n=cfg.n, e=cfg.e, rw=4)  # E = 6
    with pytest.raises(RuntimeError, match="launch failed"):
        ef.encode_levels(x, counts, q, b, n=cfg.n, e=cfg.e, rw=3)
    dense = torch.zeros(64 * 6, dtype=torch.uint8, device=cuda)
    idx = torch.arange(64 * 6, dtype=torch.int32, device=cuda)
    seg = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        df.v3_expand_unpredict_cuda(dense, idx, seg, num_windows=64, e=6,
                                    pred_id=1, bands=2, tile_windows=300)


def _store_non_default(cache, dec, enc, cs, sigs, doms, tables):
    """Store, under the exact keys the engines consult, a legal launch
    shape other than each kernel's own pick."""
    from repro_torch.kernels import decode_fused as dfm
    from repro_torch.kernels import encode_fused as efm
    from repro_torch.kernels import tiles
    from repro_torch.tuning.autotune import backend_key

    backend = backend_key("cuda")
    groups = {}
    for c in cs:
        groups.setdefault(c.plan_key, []).append(c)
    for key, members in groups.items():
        _, n, e, l_max, coding = key
        wp = dec.scheduler.round(sum(c.num_words for c in members))
        nw = dec.scheduler.round(sum(c.num_windows for c in members))
        ms = symlen_bucket(max(c.max_symlen for c in members))
        blocks = {"idct_rw": 4 if tiles.idct_tile_shape(e, n).rw == 8
                  else 8}
        if tuple(coding) != (0, 0, False):
            blocks["v3_tile_windows"] = 256 if tiles.v3_tile_windows(
                e) != 256 else 512
        cache.store("decode", backend,
                    dfm.tuning_plan_key(n, e, l_max, ms, coding), (wp, nw),
                    blocks)
    for s, d in zip(sigs, doms):
        cfg = tables[d].config
        wb = enc.scheduler.round(max(-(-len(s) // cfg.n), 1))
        kp = enc.scheduler.round(sum(
            1 for s2, d2 in zip(sigs, doms) if d2 == d and enc.scheduler.round(
                max(-(-len(s2) // cfg.n), 1)) == wb))
        chunk = min(1024, wb * cfg.e)
        pick = tiles.dct_tile_shape(cfg.n, cfg.e).rw
        rw = 1 if pick != 1 else 2
        if rw not in tiles.levels_rws(cfg.n, cfg.e):
            continue
        cache.store("encode", backend,
                    efm.tuning_plan_key(cfg.n, cfg.e, chunk, cfg.coding),
                    (kp, wb * cfg.n), {"levels_rw": rw})


def test_warm_cache_engines_match_cold(cuda, tmp_path):
    """BatchDecoder, BatchEncoder and Transcoder with a tuning cache that
    holds non-default launch shapes under the keys they consult: the cold
    cache's bytes, the same launch counts, and the entries really hit."""
    from repro_torch.tuning import autotune

    cs, sigs, doms, tables = _tuning_archive(seed=600)
    twin = [d + 2 if d < 2 else d - 2 for d in doms]
    cache = autotune.TuningCache(str(tmp_path))
    autotune.set_default_cache(cache)
    try:
        runs = []
        for warm in (False, True):
            dec, enc = BatchDecoder(), BatchEncoder()
            tc = Transcoder(decoder=dec, encoder=enc)
            if warm:
                _store_non_default(cache, dec, enc, cs, sigs, doms, tables)
                hits0 = cache.hits
            ops.reset_launches()
            out = dec.decode(cs, tables).to_host()
            got = enc.encode(sigs, tables, domain_ids=doms).to_host()
            tco = tc.transcode(cs, tables, tables,
                               dst_domain_ids=twin).to_host()
            runs.append((out, [c.to_bytes() for c in got],
                         [c.to_bytes() for c in tco], dict(ops.LAUNCHES)))
            dec.close()
            enc.close()
        assert cache.hits > hits0
        (a_out, a_enc, a_tc, a_n), (b_out, b_enc, b_tc, b_n) = runs
        for x, y in zip(a_out, b_out):
            np.testing.assert_array_equal(x, y)
        assert a_enc == b_enc and a_tc == b_tc and a_n == b_n
    finally:
        autotune.set_default_cache(None)


def test_two_shards_on_one_card_match_one(cuda):
    """An archive slice over ``devices=(cuda:0, cuda:0)``: decode, encode
    and transcode bytes equal to one shard's, the batch axis split (each
    decode group of three and each encode bucket of signals of one length
    into two buckets)."""
    cs, sigs, doms, tables = _tuning_archive(seed=700)
    twin = [d + 2 if d < 2 else d - 2 for d in doms]
    same_len = [make_signal("load_power", 4100, seed=800 + i)
                for i in range(4)]
    out = {}
    for k in (1, 2):
        devs = ("cuda:0",) * k
        dec, enc = BatchDecoder(devices=devs), BatchEncoder(devices=devs)
        tc = Transcoder(decoder=dec, encoder=enc)
        dec_out = dec.decode(cs, tables).to_host()
        dec_n = dec.stats.dispatches
        enc_out = [c.to_bytes() for c in enc.encode(
            sigs, tables, domain_ids=doms).to_host()]
        d0 = enc.stats.dispatches
        one = [c.to_bytes() for c in enc.encode(
            same_len, tables[1]).to_host()]
        one_n = enc.stats.dispatches - d0
        tc_out = [c.to_bytes() for c in tc.transcode(
            cs, tables, tables, dst_domain_ids=twin).to_host()]
        out[k] = (dec_out, enc_out, tc_out, one, dec_n, one_n)
        dec.close()
        enc.close()
    for x, y in zip(out[1][0], out[2][0]):
        np.testing.assert_array_equal(x, y)
    assert out[1][1:4] == out[2][1:4]
    assert (out[1][4], out[2][4]) == (len(tables), 2 * len(tables))
    assert (out[1][5], out[2][5]) == (1, 2)


def test_autotune_cli_warms_a_cache_the_engines_use(cuda, tmp_path,
                                                    monkeypatch):
    """``python -m repro_torch.tuning.autotune --smoke`` on the card writes
    a cache file whose entries the engines then consult: a decode of the
    CLI's synthetic bucket through ``BatchDecoder.decode_streams`` hits its
    entry, with the cold cache's samples."""
    from repro_torch.serving import StreamGroup
    from repro_torch.tuning import autotune

    assert autotune._main(["--smoke", "--cache-dir", str(tmp_path),
                           "--datasets", "load_power"]) == 0
    cache = autotune.TuningCache(str(tmp_path))
    assert len(cache) == 4  # two decode and two encode shapes
    tab = calibrate(np.concatenate(
        [make_signal("load_power", 65536, seed=90 + i) for i in range(2)]),
        DOMAIN_DEFAULTS["power"])
    bucket = autotune.decode_bucket_inputs(tab, num_words=4096,
                                           num_windows=512, device=cuda)
    words, sl = bucket["args"][:2]
    cfg = tab.config
    grp = StreamGroup(
        plan_key=(tab.domain_id, cfg.n, cfg.e, cfg.l_max, cfg.coding),
        words=words, symlen=sl, max_symlen=bucket["kw"]["max_symlen"],
        members=[(512, 512 * cfg.n)])
    cold = BatchDecoder().decode_streams([grp], tab).to_host()
    monkeypatch.setenv("FPTC_TUNING_CACHE", str(tmp_path))
    autotune.set_default_cache(None)
    try:
        live = autotune.default_cache()
        assert live.directory == str(tmp_path)
        warm = BatchDecoder().decode_streams([grp], tab).to_host()
        assert live.hits == 1
    finally:
        monkeypatch.delenv("FPTC_TUNING_CACHE")
        autotune.set_default_cache(None)
    np.testing.assert_array_equal(warm[0], cold[0])


# ---------------------------------------------------------------------------
# The LM serving path (M10a) on the card.
# ---------------------------------------------------------------------------
LM_SMOKE = ("granite_8b", "minitron_4b", "gemma2_27b", "qwen15_4b",
            "internvl2_26b", "llama4_scout_17b_a16e", "deepseek_v3_671b",
            "hymba_15b", "rwkv6_3b", "whisper_tiny")
LM_FAMILIES = ("llama4_scout_17b_a16e", "deepseek_v3_671b", "hymba_15b",
               "rwkv6_3b", "whisper_tiny")
LM_BOUND = 2.0 ** -6  # the CPU parity tests' bound: 2 bf16 ulps, relative


def _lm_rel(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def _lm_batch(cfg, b: int = 2, s: int = 16) -> dict:
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s)))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.full(
            (b, cfg.vision_prefix, cfg.d_model), 0.01, dtype=torch.bfloat16)
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model))).to(torch.bfloat16)
    return batch


@pytest.mark.parametrize("arch", LM_SMOKE)
def test_lm_smoke_on_card_matches_cpu(cuda, arch):
    """A smoke model built on the CPU, then moved to the card: prefill and
    4 decode steps (the CPU's greedy tokens fed to both) within 2 bf16
    ulps relative L2."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.train import make_serve_fns
    from repro_torch.models import build_model

    cfg = get_smoke(arch)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    batch = _lm_batch(cfg)
    s = batch["tokens"].shape[1] + (cfg.vision_prefix
                                    if cfg.family == "vlm" else 0)
    arms = {}
    for dev in ("cpu", cuda):
        prefill_fn, decode_fn = make_serve_fns(model, dev)
        logits, cache = prefill_fn(batch, s + 4)
        out = [logits]
        for i in range(4):
            tok = (arms["cpu"] if arms else out)[i].argmax(-1, keepdim=True)
            logits, cache = decode_fn(cache, tok.cpu(), s + i)
            out.append(logits)
        arms["cpu" if not arms else "cuda"] = out
    assert all(t.is_cuda for t in arms["cuda"])
    for got, want in zip(arms["cuda"], arms["cpu"]):
        assert _lm_rel(got, want) <= LM_BOUND


def test_lm_decode_step_waits_for_the_card_nowhere(cuda):
    """After one warm step, ``decode_step`` (and the greedy argmax) runs
    under ``set_sync_debug_mode("error")``: the position stays on the
    card and the cache is written in place."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.train import make_serve_fns
    from repro_torch.models import build_model

    model = build_model(get_smoke("gemma2_27b"))
    assert model.device.type == "cuda"
    prefill_fn, decode_fn = make_serve_fns(model)
    logits, cache = prefill_fn(_lm_batch(model.cfg), 24)
    tok = logits.argmax(-1, keepdim=True)
    decode_fn(cache, tok, 16)  # warm
    torch.cuda.synchronize()
    k = cache["group0"]["k"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(3):
            logits, cache = decode_fn(cache, tok, 16 + i)
            tok = logits.argmax(-1, keepdim=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert cache["group0"]["k"] is k
    assert bool(k[:, :, 18].any()) and not bool(k[:, :, 19:].any())


@pytest.mark.parametrize("arch", LM_FAMILIES)
def test_lm_family_decode_waits_for_the_card_nowhere(cuda, arch):
    """The MoE dispatch, MLA's absorbed decode, the hybrid's ring and SSM
    step, RWKV's state and whisper's two caches run under
    ``set_sync_debug_mode("error")`` after one warm step; a MoE layer's
    drop count, when asked for, stays a tensor on the card."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.train import make_serve_fns
    from repro_torch.models import build_model

    model = build_model(get_smoke(arch))
    for _, _, layer in model.layers():
        if layer.kind == "moe":
            layer.moe_stats = {}
    prefill_fn, decode_fn = make_serve_fns(model)
    logits, cache = prefill_fn(_lm_batch(model.cfg, s=48), 56)
    tok = logits.argmax(-1, keepdim=True)
    decode_fn(cache, tok, 48)  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(3):
            logits, cache = decode_fn(cache, tok, 48 + i)
            tok = logits.argmax(-1, keepdim=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(logits).all())
    for _, _, layer in model.layers():
        if layer.kind == "moe":
            assert layer.moe_stats["dropped"].is_cuda


def test_serve_lm_kv_compress_on_card_equals_the_codec(cuda, capsys):
    """``serve_lm --kv-compress`` on the card (no device given) runs and
    prints its lines; ``compress_cache`` equals ``KVCacheCodec`` called
    directly on each block, every K5 and K3 launch counted."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model
    from repro_torch.serving import KVCacheCodec

    gen = serve_lm.main(["--arch", "granite-8b", "--smoke", "--batch", "2",
                         "--prompt-len", "32", "--gen", "4",
                         "--kv-compress"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert lines[0] == "kv cache: 16384 B -> 8192 B (ratio 0.500)"
    assert lines[1].startswith("prefill: ") and gen.shape == (2, 4)

    model = build_model(get_smoke("granite_8b"))
    with torch.inference_mode():
        _, cache = model.prefill(_lm_batch(model.cfg, s=32), 36)
        before = {k: cache["group0"][k].clone() for k in ("k", "v")}
        ops.reset_launches()
        raw, comp = serve_lm.compress_cache(KVCacheCodec(), cache, 32)
        launches = dict(ops.LAUNCHES)
        direct = KVCacheCodec()
        for k in ("k", "v"):
            for layer in range(before[k].shape[0]):
                block = before[k][layer, :, :32]
                direct.calibrate(block, layer=layer)
                want = direct.decompress(direct.compress(block, layer=layer),
                                         layer=layer)
                assert torch.equal(cache["group0"][k][layer, :, :32], want)
            assert not bool(cache["group0"][k][:, :, 32:].any())
    blocks = 2 * model.cfg.num_layers
    assert launches == {k: blocks * (k in ("dct_quant", "idct_dequant"))
                        for k in launches}
    assert comp * 2 == raw


# ---------------------------------------------------------------------------
# LM training (M10b) on the card.
# ---------------------------------------------------------------------------
# the smoke granite's steps on the card against the CPU: each loss
# relative, and the weights' change relative L2 (the CPU trajectory bounds
# of tests/test_torch_train.py)
TRAIN_LOSS_BOUND = 2.0 ** -8
TRAIN_CHANGE_BOUND = 2.0 ** -2


def _train_arm(dev, steps=3, seed=0, arch="granite_8b", seq=64):
    """The smoke ``arch`` drawn on the CPU from ``seed``, trained ``steps``
    steps on ``dev`` on seeded 2 x ``seq`` token batches: the losses, the
    grad norms and each weight's change (on the CPU, fp32)."""
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.optimizer import AdamW, AdamWConfig
    from repro_torch.distributed.train import make_train_step
    from repro_torch.launch.train import make_batch
    from repro_torch.models import build_model

    cfg = get_smoke(arch)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    start = {n: p.detach().float().clone()
             for n, p in model.named_parameters()}
    ts = make_train_step(model, AdamW(AdamWConfig(
        base_lr=1e-3, warmup=1, total_steps=20)), dev)
    pipe = TokenPipeline(cfg.vocab_size, 2, seq, seed=seed)
    st, losses, norms = ts.init(), [], []
    for i in range(steps):
        st, met = ts.step_fn(st, make_batch(cfg, pipe, i))
        assert met["loss"].device.type == torch.device(dev).type
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return losses, norms, {n: p.detach().float().cpu() - start[n]
                           for n, p in model.named_parameters()}


def _hold_card_to_cpu(arch, cuda, seq=64):
    """Three train steps of the smoke ``arch`` from one draw of weights, on
    the card and on the CPU: each loss within ``TRAIN_LOSS_BOUND``, the
    weights' change within ``TRAIN_CHANGE_BOUND``."""
    lc, _, dc = _train_arm("cpu", arch=arch, seq=seq)
    lg, _, dg = _train_arm(cuda, arch=arch, seq=seq)
    for g, c in zip(lg, lc):
        assert abs(g - c) <= TRAIN_LOSS_BOUND * abs(c), (lg, lc)
    num = sum(float(torch.sum((dg[n] - dc[n]) ** 2)) for n in dc)
    den = sum(float(torch.sum(dc[n] ** 2)) for n in dc)
    assert (num / den) ** 0.5 <= TRAIN_CHANGE_BOUND


def test_train_steps_on_card_match_cpu(cuda):
    """The smoke granite (``_hold_card_to_cpu``)."""
    _hold_card_to_cpu("granite_8b", cuda)


def test_moe_mla_train_steps_on_card_match_cpu(cuda):
    """The smoke deepseek-v3 (MLA attention, one dense layer and two MoE
    layers of 8 experts, top 2, and the shared expert): the backward of
    the experts' gathers and of the MLA projections on the card tracks the
    CPU's (``_hold_card_to_cpu``)."""
    _hold_card_to_cpu("deepseek_v3_671b", cuda)


@pytest.mark.parametrize("arch", ["hymba_15b", "rwkv6_3b"])
def test_scan_train_steps_on_card_match_cpu(cuda, arch):
    """The smoke hymba (the SSM scan beside attention) and rwkv6-3b (the
    wkv recurrence) over 2 x 256 tokens, so that each scan takes its
    chunked path, a checkpoint per chunk of 128 steps, on both sides
    (``_hold_card_to_cpu``)."""
    _hold_card_to_cpu(arch, cuda, seq=256)


def test_train_resume_through_a_compressed_checkpoint_on_card(
        cuda, tmp_path, capsys):
    """``launch.train --ckpt-compress`` on the card (no device given): 2
    steps and a checkpoint, then a relaunch that restores it and takes 2
    more.  The save launches ``encode_levels`` and ``symlen_pack`` once per
    encode bucket, the restore ``symlen_decode`` and ``lut_idct`` once per
    decode bucket, and the resumed losses are finite."""
    from repro_torch.launch import train

    argv = ["--arch", "granite-8b", "--smoke", "--batch", "2", "--seq",
            "64", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--ckpt-compress", "--log-every", "1"]
    ops.reset_launches()
    model, st, _ = train.main(argv + ["--steps", "2"])
    saved = dict(ops.LAUNCHES)
    assert model.device.type == "cuda" and st.step.is_cuda
    with open(tmp_path / "step_000000000002" / "manifest.json") as f:
        manifest = json.load(f)
    lengths = [n for leaf in manifest["state"]["leaves"]
               for n in leaf["lengths"]]
    buckets = len({p2(-(-n // 64)) for n in lengths})
    assert saved["encode_levels"] == saved["symlen_pack"] == buckets > 0
    assert saved["symlen_decode"] == saved["lut_idct"] == 0
    capsys.readouterr()
    ops.reset_launches()
    _, st, losses = train.main(argv + ["--steps", "4"])
    restored = dict(ops.LAUNCHES)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from step 2"
    assert restored["symlen_decode"] == restored["lut_idct"] == 1
    # the relaunch saves again at step 4
    assert restored["encode_levels"] == restored["symlen_pack"] == buckets
    assert int(st.step) == 4 and len(losses) == 2
    assert all(np.isfinite(losses))


def test_train_raw_resume_on_card_is_the_uninterrupted_run(cuda, tmp_path,
                                                           capsys):
    """``launch.train`` on the card: 4 steps with a raw checkpoint at 2,
    relaunched from it, ends bit for bit where an uninterrupted 4-step run
    ends (weights, m and v): the card's train step is deterministic."""
    from repro_torch.launch import train

    argv = ["--arch", "granite-8b", "--smoke", "--batch", "2", "--seq",
            "64", "--ckpt-every", "2", "--log-every", "1"]
    once, st_once, losses = train.main(
        argv + ["--steps", "4", "--ckpt-dir", str(tmp_path / "once")])
    train.main(argv + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    model, st, second = train.main(
        argv + ["--steps", "4", "--ckpt-dir", str(tmp_path / "b")])
    assert "resumed from step 2" in capsys.readouterr().out
    assert second == losses[2:]
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 once.named_parameters()):
        assert p.is_cuda and torch.equal(p, q), name
        assert torch.equal(st.m[name], st_once.m[name]), name
        assert torch.equal(st.v[name], st_once.v[name]), name


def test_pod_compressed_ranks_on_card_are_the_oracle(cuda):
    """Two ranks on the one card (gloo passes CUDA tensors), one pod
    replica each: losses, weights and residuals bit for bit the one-process
    oracle's on the card."""
    import _mesh_ranks
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.compression import (
        CompressionConfig,
        GradCompressor,
    )
    from repro_torch.distributed.optimizer import AdamW, AdamWConfig
    from repro_torch.models import build_model
    from repro_torch.models.convert import stack_layers, unstack_layers

    seed, steps, b, s, min_size = 0, 3, 2, 64, 256
    ranks = _mesh_ranks.run_ranks(2, [("pod_steps", dict(
        device="cuda", seed=seed, steps=steps, batch=b, seq=s,
        min_size=min_size))])
    cfg = get_smoke("granite_8b")
    model = build_model(cfg, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(seed))
    model.requires_grad_(True)
    opt = AdamW(AdamWConfig(**_mesh_ranks.OPT))
    comp = GradCompressor(CompressionConfig(min_size=min_size))
    params = dict(model.named_parameters())
    st, losses = opt.init(params, with_residual=True, replicas=2), []
    for batch in _mesh_ranks.smoke_batches(cfg, seed, steps, b, s):
        per, grads = [], []
        for p in range(2):
            loss = model.loss({k: v[p:p + 1] for k, v in batch.items()})
            per.append(loss.detach())
            grads.append(torch.autograd.grad(loss, list(params.values())))
        mean, res = comp.replica_sum(stack_layers(model, {
            n: torch.stack([g[i] for g in grads])
            for i, n in enumerate(params)}, layer_axis=1), stack_layers(
            model, st.residual, layer_axis=1))
        _, st, _ = opt.update(params, st, unstack_layers(mean, model),
                              unstack_layers(res, model, layer_axis=1))
        losses.append(float(torch.stack(per).mean()))
    for rank, (out,) in enumerate(ranks):
        assert out["losses"] == losses
        for n, p in params.items():
            assert np.array_equal(out["params"][n], p.detach().float()
                                  .cpu().numpy()), n
            assert np.array_equal(out["residual"][n], st.residual[n][
                rank:rank + 1].float().cpu().numpy()), n
