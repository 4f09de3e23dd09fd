"""The port's gradient compressor (M8): ``replica_sum``'s numerical
contracts and ``wire_bytes``, held against the JAX package.

Gradients are made from seeds with numpy and cross as arrays.  Each mode's
mean equals the reference's on the same gradients within ``1e-6 *
max|ref|`` per leaf (the two DCTs and means sum in different orders; these
inputs differ by at most 1.4e-7 of max|ref|), and a bfloat16 residual
within one bfloat16 ulp of the reference's value.  No int8 or bfloat16
rounding of a spectrum lands on a different side here; a coefficient on a
rounding boundary could, by the same summation orders."""
import pytest

jnp = pytest.importorskip("jax.numpy")  # the reference; absent on the card

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.distributed.compression import CompressionConfig as RefConfig
from repro.distributed.compression import GradCompressor as RefCompressor
from repro_torch.distributed.compression import (
    CompressionConfig,
    GradCompressor,
)

REL_TOL = 1e-6


def _grads(p=2, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((p, n)).astype(np.float32) * np.float32(0.01),
        "b": rng.standard_normal((p, 64)).astype(np.float32),  # small
    }


def _both(cfg_kw, grads, residual=None):
    """(port out, port residual, ref out, ref residual) as numpy."""
    port = GradCompressor(CompressionConfig(**cfg_kw))
    ref = RefCompressor(RefConfig(**cfg_kw))
    t = {k: torch.from_numpy(v) for k, v in grads.items()}
    j = {k: jnp.asarray(v) for k, v in grads.items()}
    tr = jr = None
    if residual is not None:
        tr = {k: torch.from_numpy(v).to(torch.bfloat16)
              for k, v in residual.items()}
        jr = {k: jnp.asarray(v, jnp.bfloat16) for k, v in residual.items()}
    out, res = port.replica_sum(t, tr)
    rout, rres = ref.replica_sum(j, jr)
    f = lambda x: np.asarray(jnp.asarray(x, jnp.float32))  # noqa: E731
    g = lambda x: x.float().numpy()  # noqa: E731
    return ({k: g(v) for k, v in out.items()},
            None if res is None else {k: g(v) for k, v in res.items()},
            {k: f(v) for k, v in rout.items()},
            None if rres is None else {k: f(v) for k, v in rres.items()})


def test_mode_none_is_plain_mean():
    g = _grads()
    out, _, ref, _ = _both(dict(mode="none"), g)
    np.testing.assert_allclose(out["w"], g["w"].mean(0), rtol=1e-6)
    np.testing.assert_allclose(out["w"], ref["w"], rtol=1e-6)


def test_small_leaves_bypass_compression():
    g = _grads()
    out, _, ref, _ = _both(dict(mode="truncate_int8", min_size=4096), g)
    # "b" (64 elems) bypasses: exact mean
    np.testing.assert_allclose(out["b"], g["b"].mean(0), rtol=1e-6)
    np.testing.assert_allclose(out["b"], ref["b"], rtol=1e-6)


def test_int8_quantization_error_bounded():
    g = _grads()
    out, _, ref, _ = _both(dict(mode="truncate_int8", n=64, e=64), g)
    want = g["w"].mean(0)
    rel = np.linalg.norm(out["w"] - want) / np.linalg.norm(want)
    assert rel < 0.02, rel  # int8 of the spectrum: ~1% error
    assert np.abs(out["w"] - ref["w"]).max() <= REL_TOL * np.abs(
        ref["w"]).max()


def test_truncation_equals_projected_mean():
    cfg = CompressionConfig(mode="truncate", n=32, e=8)
    comp = GradCompressor(cfg)
    g = _grads()
    out, _, ref, _ = _both(dict(mode="truncate", n=32, e=8), g)
    mean = torch.from_numpy(g["w"]).mean(0)
    spec, size = comp._to_spectrum(mean)
    proj = comp._from_spectrum(spec.to(torch.bfloat16), size, mean.shape,
                               torch.float32)
    np.testing.assert_allclose(out["w"], proj.numpy(), atol=2e-4)
    np.testing.assert_allclose(out["w"], ref["w"], atol=2e-4)


@pytest.mark.parametrize("mode", ["truncate", "truncate_int8",
                                  "replicated_f32"])
def test_replica_sum_matches_reference(mode):
    g = _grads(p=3, n=5000, seed=1)  # a partial last window
    r = {k: (np.random.default_rng(2).standard_normal(v.shape) * 1e-3)
         .astype(np.float32) for k, v in g.items()}
    out, res, ref, rres = _both(dict(mode=mode, n=32, e=8), g, r)
    for k in g:
        assert np.abs(out[k] - ref[k]).max() <= REL_TOL * np.abs(
            ref[k]).max(), (mode, k)
        assert res[k].shape == rres[k].shape
        assert np.all(np.abs(res[k] - rres[k]) <= np.abs(rres[k]) * 2.0 ** -7
                      ), (mode, k)


def test_residual_tracks_filtered_mass_and_decays():
    g = _grads()
    r0 = {k: np.zeros_like(v) for k, v in g.items()}
    _, r1, _, ref_r1 = _both(dict(mode="truncate", n=32, e=8,
                                  ef_decay=0.9), g, r0)
    # residual is nonzero exactly where compression was lossy
    assert float(np.abs(r1["w"]).max()) > 0
    # and scaled by ef_decay: |r1| <= 0.9 * |g_filtered| <= 0.9 * |g|
    assert np.linalg.norm(r1["w"]) <= 0.91 * np.linalg.norm(g["w"])
    assert np.array_equal(r1["b"], ref_r1["b"])  # the bypass keeps r


def test_wire_ratio_property():
    for n, e in ((64, 32), (64, 16), (32, 8)):
        cfg = CompressionConfig(mode="truncate_int8", n=n, e=e)
        comp = GradCompressor(cfg)
        elems = n * 1000
        assert comp.wire_bytes(elems) == 1000 * e
        assert cfg.ratio == pytest.approx((e / n) / 4.0)
        ref = RefCompressor(RefConfig(mode="truncate_int8", n=n, e=e))
        assert comp.wire_bytes(elems) == ref.wire_bytes(elems)
        assert cfg.ratio == ref.config.ratio


def test_wire_bytes_all_modes():
    """Every declared mode has a wire-byte account — the uncompressed
    baselines report true f32 bytes — equal to the reference's."""
    n, e, num = 64, 16, 1000
    for mode in ("none", "replicated_f32", "truncate", "truncate_int8"):
        port = GradCompressor(CompressionConfig(mode=mode, n=n, e=e))
        ref = RefCompressor(RefConfig(mode=mode, n=n, e=e))
        assert port.wire_bytes(num) == ref.wire_bytes(num), mode
        assert port.config.ratio == ref.config.ratio
    w = -(-num // n)
    assert GradCompressor(CompressionConfig(
        mode="truncate", n=n, e=e)).wire_bytes(num) == w * e * 2  # bf16
    assert GradCompressor(CompressionConfig(
        mode="truncate", n=n, e=e, wire_dtype=torch.float32)
    ).wire_bytes(num) == w * e * 4
    with pytest.raises(ValueError, match="unknown compression mode"):
        GradCompressor(CompressionConfig(mode="gzip")).wire_bytes(num)
    with pytest.raises(ValueError, match="unknown compression mode"):
        GradCompressor(CompressionConfig(mode="gzip")).replica_sum(
            {"w": torch.zeros(2, 4096)}, None)
