"""The plain versions of the dequant + iDCT kernels held to the JAX reference
on the layouts of ``tests/_idct_layouts.py`` (each (E, N) pair at 1
window, less than one tile, one window past a multiple of the tile, and
259 windows; row r < 256 holding level r in every band), at small sizes:

  * ``lut_idct_plain`` (K2's last stage): against the reference's XLA arm's
    LUT path (``repro.serving.batch_decode._decode_fixed``: the
    ``lut[k, level]`` gather, then ``@ basis``) on the same LUT and basis;
    on the exhaustive layout (levels [256, E], basis [I_E | 0]) its first E
    columns equal the LUT (transposed) exactly;
  * ``idct_dequant_plain`` (K3): against ``repro.kernels.ref.
    idct_dequant_ref`` on the same quant table, and on the exhaustive
    layout against the reference's ``dequantize``.

Floats within ``max|d| <= 1e-5 * max|ref|``: torch's CPU product sums in
another order than XLA's, and torch's and XLA's ``expm1``/``log1p`` round
differently (K3's dequant: up to 5 ulp).  The kernels against these plain
versions on the same layouts, on the card: ``tests/test_torch_gpu.py``.
"""
import pytest

jnp = pytest.importorskip("jax.numpy")  # the reference; absent on the card

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _idct_layouts import PAIRS, every_level, idct_case, widths  # noqa: E402
from repro.core.quantize import QuantTable as RefQuantTable  # noqa: E402
from repro.core.quantize import dequantize as ref_dequantize  # noqa: E402
from repro.kernels.ref import idct_dequant_ref  # noqa: E402
from repro.serving.batch_decode import _decode_fixed  # noqa: E402
from repro_torch.core import dct  # noqa: E402
from repro_torch.core.quantize import quant_table_from_arrays  # noqa: E402
from repro_torch.kernels import decode_fused as df  # noqa: E402
from repro_torch.kernels import idct_dequant as idq  # noqa: E402

REL_TOL = 1e-5
# one XLA program a shape, in place of one eager op at a time
_ref_k3 = jax.jit(idct_dequant_ref, static_argnames="n")
_ref_dequantize = jax.jit(ref_dequantize)


def _ids(pair):
    return "e{}-n{}".format(*pair)


def assert_close(got, ref, rel=REL_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    bound = rel * max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= bound


def _tables(c):
    ref_q = RefQuantTable(jnp.asarray(c["zone"]), jnp.asarray(c["scale"]),
                          jnp.asarray(c["mu"]), jnp.asarray(c["alpha1"]))
    port_q = quant_table_from_arrays(c["zone"], c["scale"], c["mu"],
                                     c["alpha1"])
    return ref_q, port_q


@pytest.mark.parametrize("pair", PAIRS, ids=_ids)
def test_lut_idct_plain_on_layouts(pair):
    e, n = pair
    for w in widths(e, n, big=False):
        c = idct_case(e, n, w)
        got = df.lut_idct_plain(torch.from_numpy(c["levels"]),
                                torch.from_numpy(c["lut"]),
                                torch.from_numpy(c["basis"]))
        ref = _decode_fixed(jnp.asarray(c["levels"]), jnp.asarray(c["lut"]),
                            jnp.asarray(c["basis"]), e=e)
        assert_close(got.numpy(), np.asarray(ref).reshape(w, n))
    levels, eye = every_level(e, n)
    got = df.lut_idct_plain(torch.from_numpy(levels),
                            torch.from_numpy(c["lut"]), torch.from_numpy(eye))
    np.testing.assert_array_equal(got[:, :e].numpy(), c["lut"].T)
    assert not got[:, e:].any()


@pytest.mark.parametrize("pair", PAIRS, ids=_ids)
def test_idct_dequant_plain_on_layouts(pair):
    e, n = pair
    basis = dct.idct_basis(n, e)
    for w in widths(e, n, big=False):
        c = idct_case(e, n, w)
        ref_q, port_q = _tables(c)
        got = idq.idct_dequant_plain(torch.from_numpy(c["levels"]), port_q,
                                     basis)
        ref = _ref_k3(jnp.asarray(c["levels"]), ref_q, n=n)
        assert_close(got.numpy(), ref)
    levels, eye = every_level(e, n)
    got = idq.idct_dequant_plain(torch.from_numpy(levels), port_q,
                                 torch.from_numpy(eye))
    assert_close(got[:, :e].numpy(),
                 _ref_dequantize(jnp.asarray(levels), ref_q))
    assert not got[:, e:].any()
