"""The plain versions of the DCT + quantize kernels held to the JAX reference
on the adversarial layouts of ``tests/_levels_layouts.py`` (block and row
edges under v3 prediction, counts ending mid-block and mid-window, gather
starts off a 16-byte boundary, lens of 0 and of the full width, shared
runs), at small sizes (the widest row two blocks plus 3 windows):

  * ``encode_levels_plain``: the grid against the reference's
    ``quantize(forward_dct(window_signal(...)))`` then ``predict_levels``
    (the first lines of ``repro.serving.batch_encode._encode_bucket_math``),
    and under zero planes ``ncoded``, ``zrow`` and ``zcol`` against
    ``_encode_bucket_math`` itself;
  * ``encode_levels_gather_plain``: the same on the reference's
    ``_gather_rows_math`` of the layout's ``(flat, starts, lens)``;
  * ``dct_quant_plain``: against ``repro.kernels.ref.dct_quant_ref``.

With the identity basis (the coefficients are the inputs) every output is
equal.  With the DCT basis torch's product on the CPU sums in another order
than XLA's at some shapes, so a coefficient within an ulp of a quantizer
cell boundary can land one level away: the levels (before prediction)
obey the flip rule of ``tests/test_torch_gpu.py`` (every differing level
one apart, in at most 1e-5 of the cells, or one cell), and every row with
no flipped level is equal in every output.  The kernels against these
plain versions on the same layouts, on the card: ``tests/test_torch_gpu.py``.
"""
import pytest

jnp = pytest.importorskip("jax.numpy")  # the reference; absent on the card

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _levels_layouts import (  # noqa: E402
    CODINGS,
    PAIRS,
    dct_case,
    levels_case,
    widths,
)
from repro.core import dct as ref_dct  # noqa: E402
from repro.core.calibration import DeviceTables as RefTables  # noqa: E402
from repro.core.quantize import QuantTable as RefQuantTable  # noqa: E402
from repro.core.quantize import predict_levels as ref_predict  # noqa: E402
from repro.core.quantize import quantize as ref_quantize  # noqa: E402
from repro.kernels.ref import dct_quant_ref  # noqa: E402
from repro.serving.batch_encode import _encode_bucket_math  # noqa: E402
from repro.serving.batch_encode import _gather_rows_math  # noqa: E402
from repro_torch.core import dct  # noqa: E402
from repro_torch.core.quantize import quant_table_from_arrays  # noqa: E402
from repro_torch.kernels import dct_quant as dq  # noqa: E402
from repro_torch.kernels import encode_fused as ef  # noqa: E402

FLIP_SHARE = 1e-5  # DCT basis: flips allowed per level cell
SHAPES = [(n, e, wp) for n, e in PAIRS for wp in widths(n, e, big=False)]
K5_SHAPES = [(n, e, w) for n, e in PAIRS for w in widths(n, e, big=False)]


def _ids(shape):
    return "n{}-e{}-w{}".format(*shape)


def _tables(c):
    ref_q = RefQuantTable(jnp.asarray(c["zone"]), jnp.asarray(c["scale"]),
                          jnp.asarray(c["mu"]), jnp.asarray(c["alpha1"]))
    port_q = quant_table_from_arrays(c["zone"], c["scale"], c["mu"],
                                     c["alpha1"])
    return ref_q, port_q


def _bases(n, e):
    """(name, reference basis, port basis): the identity's first e columns
    and the DCT basis."""
    eye = np.eye(n, dtype=np.float32)[:, :e]
    return [("identity", jnp.asarray(eye), torch.from_numpy(eye.copy())),
            ("dct", ref_dct.dct_basis(n, e), dct.dct_basis(n, e))]


def _ref_grid(rows, n, basis, ref_q, coding):
    levels = ref_quantize(ref_dct.window_signal(rows, n) @ basis, ref_q)
    return np.asarray(ref_predict(levels, coding[0], coding[1]))


def _ref_masks(rows, counts, ref_q, n, e, coding):
    """(ncoded, zrow, zcol) of ``_encode_bucket_math`` (its DCT basis)."""
    tables = RefTables(
        jnp.arange(256, dtype=jnp.uint32), jnp.full(256, 8, jnp.int32),
        jnp.zeros(8, jnp.uint32), jnp.zeros(9, jnp.uint32),
        jnp.zeros(9, jnp.int32), jnp.zeros(256, jnp.int32), ref_q)
    out = _encode_bucket_math(rows, jnp.asarray(counts), tables, n=n, e=e,
                              chunk_size=4096, check_gaps=False,
                              coding=coding)
    return [np.asarray(o) for o in out[5:]]


def _check(got, levels, rows, counts, ref_q, n, e, coding, basis_name,
           ref_basis):
    """``got`` (the plain outputs) and ``levels`` (the plain levels before
    prediction) against the reference on ``rows``."""
    lv_ref = _ref_grid(rows, n, ref_basis, ref_q, (0, 0, False))
    lv = levels.numpy()
    d = np.abs(lv.astype(np.int64) - lv_ref)
    if basis_name == "identity":
        assert not d.any()
    else:  # the flip rule
        assert d.max(initial=0) <= 1
        assert (d > 0).sum() <= max(1.0, FLIP_SHARE * d.size)
    clean = ~d.reshape(d.shape[0], -1).any(axis=1)
    grid, zrow, zcol, ncoded = got
    np.testing.assert_array_equal(
        grid.numpy()[clean],
        _ref_grid(rows, n, ref_basis, ref_q, coding)[clean])
    if coding == (0, 0, False):
        assert zrow is None and zcol is None and ncoded is None
        return
    if not coding[2]:
        assert zrow is None and zcol is None
        np.testing.assert_array_equal(ncoded.numpy(), counts)
        return
    if basis_name == "dct":
        want = _ref_masks(rows, counts, ref_q, n, e, coding)
        for g, w in zip((ncoded, zrow, zcol), want):
            np.testing.assert_array_equal(g.numpy()[clean], w[clean])


@pytest.mark.parametrize("coding", CODINGS,
                         ids=lambda c: "-".join(str(v) for v in c))
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_encode_levels_plain_on_layouts(shape, coding):
    n, e, wp = shape
    c = levels_case(n, e, wp, coding)
    ref_q, port_q = _tables(c)
    rows = jnp.asarray(c["signals"])
    for name, ref_basis, basis in _bases(n, e):
        x, counts = (torch.from_numpy(c[f]) for f in ("signals", "counts"))
        got = ef.encode_levels_plain(x, counts, port_q, basis, n=n, e=e,
                                     coding=c["coding"])
        levels = ef.encode_levels_plain(x, counts, port_q, basis, n=n,
                                        e=e)[0]
        _check(got, levels, rows, c["counts"], ref_q, n, e, c["coding"],
               name, ref_basis)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_encode_levels_gather_plain_on_layouts(shape):
    n, e, wp = shape
    c = levels_case(n, e, wp, CODINGS[2])
    ref_q, port_q = _tables(c)
    gx = [torch.from_numpy(c[f]) for f in ("flat", "starts", "lens")]
    rows = _gather_rows_math(*(jnp.asarray(c[f]) for f in (
        "flat", "starts", "lens")), c["width"])
    # the NaNs past each run are masked: the gathered rows are finite
    assert bool(jnp.isfinite(rows).all())
    np.testing.assert_array_equal(
        ef.gather_rows(*gx, c["width"]).numpy(), np.asarray(rows))
    for name, ref_basis, basis in _bases(n, e):
        kw = dict(width=c["width"], n=n, e=e)
        counts = torch.from_numpy(c["gcounts"])
        got = ef.encode_levels_gather_plain(*gx, counts, port_q, basis,
                                            coding=c["coding"], **kw)
        levels = ef.encode_levels_gather_plain(*gx, counts, port_q, basis,
                                               **kw)[0]
        _check(got, levels, rows, c["gcounts"], ref_q, n, e, c["coding"],
               name, ref_basis)


@pytest.mark.parametrize("shape", K5_SHAPES, ids=_ids)
def test_dct_quant_plain_on_layouts(shape):
    n, e, w = shape
    c = dct_case(n, e, w)
    ref_q, port_q = _tables(c)
    x = c["windows"][1:]
    want = np.asarray(dct_quant_ref(jnp.asarray(x), ref_q, e=e))
    got = dq.dct_quant_plain(torch.from_numpy(x), port_q, dct.dct_basis(n, e))
    d = np.abs(got.numpy().astype(np.int64) - want)  # the flip rule
    assert d.max(initial=0) <= 1
    assert (d > 0).sum() <= max(1.0, FLIP_SHARE * d.size)
    eye = np.eye(n, dtype=np.float32)[:, :e]
    want = np.asarray(ref_quantize(jnp.asarray(x) @ jnp.asarray(eye), ref_q))
    got = dq.dct_quant_plain(torch.from_numpy(x), port_q,
                             torch.from_numpy(eye.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
