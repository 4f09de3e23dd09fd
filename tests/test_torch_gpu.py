"""The CUDA kernels on the card, each against its plain PyTorch version on
the same inputs, and the batched decode engine on the card against itself
on the CPU.  Every test is marked ``gpu`` and skips where there is no card;
on the card run ``python -m pytest -m gpu tests/test_torch_*.py``.

This file imports neither JAX nor the reference package, so it runs where
they are absent; its inputs come from the port's own host encoder, made
from seeds with numpy.  Symbols and levels must be equal; floats within
``max|d| <= 1e-5 * max|plain|`` (the kernels sum the iDCT product in a
fixed sequential fp32 FMA order, the plain versions in cuBLAS's order, with
TF32 off)."""
import numpy as np
import pytest
import torch

from repro_torch.core import DOMAIN_DEFAULTS, calibrate, codec, dct
from repro_torch.core.container import Container
from repro_torch.core.huffman import build_codebook
from repro_torch.core.quantize import quant_grid
from repro_torch.core.symlen import pack_symlen_np, v3_expand_index
from repro_torch.data import make_signal
from repro_torch.kernels import decode_fused as df
from repro_torch.kernels import huffman_decode as hd
from repro_torch.kernels import idct_dequant as idq
from repro_torch.kernels import ops
from repro_torch.serving import BatchDecoder
from repro_torch.serving.engine import p2, symlen_bucket

pytestmark = pytest.mark.gpu

REL_TOL = 1e-5
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
        "lut_idct": 1, "idct_dequant": 0,
    }
    want = df.decode_fused_plain(*args, lut, basis, v3, n=cfg.n, **kw)
    torch.cuda.synchronize()
    assert torch.equal(lv, lvp)
    assert_close(got, want)


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
