"""The port's MLA attention (deepseek-v3: ``mla_apply_train`` and the
absorbed ``mla_apply_decode`` of ``repro_torch.models.transformer``) held
against the JAX package on the CPU.

Inputs and weights come from numpy seeds and cross bit for bit; the norms'
weights are 1 + N(0, 0.1).  Outputs and caches are held in relative L2 to
``BOUND = 2**-6`` (2 bf16 ulps).  Measured on this tree (CPU, torch 2.13,
JAX 0.9): the train path's output and both latents 0 (bit-equal), the
absorbed decode's output and written caches 0; the absorbed decode at
position S - 1 against the train path's last row (the same attention
computed two ways) 5.1e-3.
"""
import pytest

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke
from repro.models import common as ref_common
from repro.models import transformer as ref_tfm
from repro_torch.configs import get_smoke
from repro_torch.models import transformer as tfm
from test_torch_models import BOUND, both, dtype_name, randn, rel_l2

ARCH = "deepseek_v3_671b"  # smoke: d 64, 4 heads, q 32, kv 16, 16 + 8, v 16
B, S, T = 2, 21, 24


def _params(seed: int = 3):
    cfg = get_smoke(ARCH)
    pj, pt = {}, {}
    for i, (name, s) in enumerate(sorted(tfm.mla_specs(cfg).items())):
        if s.init == "ones":
            arr = 1.0 + randn(seed + i, s.shape, 0.1)
        else:
            arr = randn(seed + i, s.shape, s.std)
        pj[name], pt[name] = both(arr)
    return cfg, ref_get_smoke(ARCH), pj, pt


def _rope(cfg, positions):
    dim, theta = cfg.mla_qk_rope_dim, cfg.rope_theta
    sj, cj = ref_common.rope(jnp.asarray(positions), dim, theta)
    return (sj, cj), (torch.tensor(np.asarray(sj)),
                      torch.tensor(np.asarray(cj)))


def test_specs_match_the_reference():
    cfg, ref_cfg, _, _ = _params()
    mine, ref = tfm.mla_specs(cfg), ref_tfm.mla_specs(ref_cfg)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert (mine[k].shape, mine[k].names, mine[k].init,
                dtype_name(mine[k].dtype)) == (
            ref[k].shape, ref[k].names, ref[k].init,
            dtype_name(ref[k].dtype)), k


def test_mla_apply_train():
    """qk 24 wide (nope 16 + rope 8), v 16: the output and the latents the
    cache keeps, ``c_kv [B, S, 16]`` and ``k_rope [B, S, 8]``."""
    cfg, ref_cfg, pj, pt = _params()
    xj, xt = both(randn(1, (B, S, cfg.d_model)))
    (sj, cj), (st, ct) = _rope(cfg, np.arange(S))
    out, (ckv, kr) = tfm.mla_apply_train(cfg, pt, xt, st, ct, 0)
    r_out, (r_ckv, r_kr) = ref_tfm.mla_apply_train(ref_cfg, pj, xj, sj, cj,
                                                   jnp.int32(0))
    assert out.dtype == torch.bfloat16 and out.shape == (B, S, cfg.d_model)
    assert tuple(ckv.shape) == (B, S, cfg.mla_kv_lora_rank)
    assert tuple(kr.shape) == (B, S, cfg.mla_qk_rope_dim)
    for got, want in ((out, r_out), (ckv, r_ckv), (kr, r_kr)):
        assert rel_l2(got, want) <= BOUND


@pytest.mark.parametrize("pos", [0, 13, T - 1])
def test_mla_apply_decode(pos):
    """The absorbed decode on the reference's latents of a prefix of
    ``pos`` tokens (the slots past it zero, as prefill pads them): the
    output and both caches, slot ``pos`` written in place."""
    cfg, ref_cfg, pj, pt = _params()
    xj, _ = both(randn(1, (B, T, cfg.d_model)))
    (sj, cj), _ = _rope(cfg, np.arange(T))
    _, (ckv, kr) = ref_tfm.mla_apply_train(ref_cfg, pj, xj, sj, cj,
                                           jnp.int32(0))
    keep = (jnp.arange(T) < pos)[None, :, None]
    ckv_j = jnp.where(keep, ckv, 0).astype(jnp.bfloat16)
    kr_j = jnp.where(keep, kr, 0).astype(jnp.bfloat16)
    x1j, x1t = both(randn(2, (B, 1, cfg.d_model)))
    (s1j, c1j), (s1t, c1t) = _rope(cfg, np.full((B, 1), pos))
    ckv_t, kr_t = both(ckv_j)[1], both(kr_j)[1]
    out, (c1, c2) = tfm.mla_apply_decode(cfg, pt, x1t, s1t, c1t, 0, ckv_t,
                                         kr_t, torch.tensor(pos))
    r_out, (r1, r2) = ref_tfm.mla_apply_decode(
        ref_cfg, pj, x1j, s1j, c1j, jnp.int32(0), ckv_j, kr_j,
        jnp.int32(pos))
    assert c1 is ckv_t and c2 is kr_t  # written in place
    assert out.dtype == torch.bfloat16 and out.shape == (B, 1, cfg.d_model)
    for got, want in ((out, r_out), (c1, r1), (c2, r2)):
        assert rel_l2(got, want) <= BOUND


def test_absorbed_decode_is_the_train_path():
    """Decode at position S - 1 on the latents of the first S - 1 tokens
    gives the train path's last output row: the latent-space attention is
    the per-head attention absorbed."""
    cfg, _, _, pt = _params()
    _, xt = both(randn(4, (B, S, cfg.d_model)))
    _, (st, ct) = _rope(cfg, np.arange(S))
    want, (ckv, kr) = tfm.mla_apply_train(cfg, pt, xt, st, ct, 0)
    ckv, kr = ckv.clone(), kr.clone()
    ckv[:, S - 1:] = 0
    kr[:, S - 1:] = 0
    got, (c1, c2) = tfm.mla_apply_decode(
        cfg, pt, xt[:, S - 1:], st[S - 1:], ct[S - 1:], 0, ckv, kr,
        torch.tensor(S - 1))
    assert rel_l2(got, want[:, S - 1:]) <= BOUND
    # the written slot holds the train path's latents for that token
    _, (full_ckv, full_kr) = tfm.mla_apply_train(cfg, pt, xt, st, ct, 0)
    assert rel_l2(c1, full_ckv) <= BOUND and rel_l2(c2, full_kr) <= BOUND
