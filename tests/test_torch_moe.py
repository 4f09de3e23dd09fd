"""The port's single-device MoE layer (``moe_apply`` of
``repro_torch.models.transformer``) held against the JAX package on the
CPU: llama4-scout's top 1 of 4 experts and deepseek-v3's top 2 of 8, each
with its shared expert (the smoke models' widths).

Inputs and weights come from numpy seeds and cross bit for bit; each
expert's matrices are drawn with their own fan-in.  Outputs are held in
relative L2 to ``BOUND = 2**-6`` (2 bf16 ulps).  ``torch.topk`` and
``lax.top_k`` may order tied logits differently; with fp32 random logits
no two tie here, so the routing is the reference's.  Measured on this tree
(CPU, torch 2.13, JAX 0.9): 0 (bit-equal) but deepseek's 64-token case,
3.9e-5 (one element one bf16 ulp off: the k gated rows summed in another
order), and the pinned overflow cases 0.  The port builds no one-hot
``[E, T, C]`` or ``[T, C, E]`` tensor (every torch call's output shape is
recorded).
"""
import pytest

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke
from repro.models import transformer as ref_tfm
from repro_torch.configs import get_smoke
from repro_torch.models import transformer as tfm
from test_torch_models import BOUND, both, dtype_name, randn, rel_l2

ARCHS = ("llama4_scout_17b_a16e", "deepseek_v3_671b")


def _params(arch: str, seed: int = 3):
    """The layer's weights in both packages; an expert stack's matrices at
    ``1/sqrt(own fan-in)``, the fp32 router at ``1/sqrt(d)``."""
    cfg = get_smoke(arch)

    def draw(specs, seed):
        pj, pt = {}, {}
        for i, (name, s) in enumerate(sorted(specs.items())):
            if isinstance(s, dict):
                pj[name], pt[name] = draw(s, seed * 31 + i)
                continue
            std = s.std if s.names[0] != "experts" else s.shape[1] ** -0.5
            dtype = jnp.float32 if s.dtype == torch.float32 else jnp.bfloat16
            pj[name], pt[name] = both(randn(seed + i, s.shape, std), dtype)
        return pj, pt

    return (cfg, ref_get_smoke(arch)) + draw(tfm.moe_specs(cfg), seed)


def ref_dropped(ref_cfg, pj, xj) -> int:
    """The pairs the reference drops, by its own rule
    (``repro/models/transformer.py:309-327``): top-k of the fp32 logits,
    each pair's position in its expert counted in (token, k) order, at or
    past the capacity."""
    ne, k = ref_cfg.moe_num_experts, ref_cfg.moe_top_k
    xf = xj.reshape(-1, xj.shape[-1])
    n_tok = xf.shape[0]
    _, chosen = jax.lax.top_k(xf.astype(jnp.float32) @ pj["router"], k)
    cap = min(max(int(2 * n_tok * k / ne), 4), n_tok)
    onehot = jax.nn.one_hot(chosen, ne, dtype=jnp.int32).reshape(-1, ne)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    return int(jnp.sum(pos >= cap))


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_the_reference(arch):
    cfg, ref_cfg, _, _ = _params(arch)

    def flat(tree, prefix=""):
        out = {}
        for k, s in tree.items():
            if isinstance(s, dict):
                out.update(flat(s, f"{prefix}{k}."))
            else:
                out[prefix + k] = (s.shape, s.names, s.init,
                                   dtype_name(s.dtype))
        return out

    assert flat(tfm.moe_specs(cfg)) == flat(ref_tfm.moe_specs(ref_cfg))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_tok", [2, 24, 64])
def test_moe_apply(arch, n_tok):
    """2 tokens (capacity = T: nothing can drop), 24 and 64 (capacity
    twice the mean load)."""
    cfg, ref_cfg, pj, pt = _params(arch)
    xj, xt = both(randn(9, (2, n_tok // 2, cfg.d_model)))
    stats = {}
    got = tfm.moe_apply(cfg, pt, xt, stats)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    assert rel_l2(got, ref_tfm.moe_apply(ref_cfg, pj, xj)) <= BOUND
    assert int(stats["dropped"]) == ref_dropped(ref_cfg, pj, xj)
    assert 1 <= int(stats["experts_hit"]) <= cfg.moe_num_experts


@pytest.mark.parametrize("arch", ARCHS)
def test_an_overflowing_expert_drops_the_reference_pairs(arch):
    """Pinned: every token shares a direction the router's expert 0 reads
    (its logit about 6 above the rest), so expert 0 takes all 24 tokens
    against a capacity of 12.  The port drops the pairs the reference
    drops (the same count, > 0, and the same outputs: a dropped pair keeps
    only the shared expert)."""
    cfg, ref_cfg, pj, pt = _params(arch)
    d, n_tok = cfg.d_model, 24
    u = randn(21, (d,))
    u /= np.linalg.norm(u)
    x = randn(22, (2, n_tok // 2, d)) + 3.0 * u
    router = np.asarray(pj["router"]).copy()
    router[:, 0] += 2.0 * u
    pj["router"], pt["router"] = both(router, jnp.float32)
    xj, xt = both(x)
    want_dropped = ref_dropped(ref_cfg, pj, xj)
    assert tfm.moe_capacity(cfg, n_tok) == 12
    assert want_dropped >= 12
    stats = {}
    got = tfm.moe_apply(cfg, pt, xt, stats)
    assert int(stats["dropped"]) == want_dropped
    assert rel_l2(got, ref_tfm.moe_apply(ref_cfg, pj, xj)) <= BOUND


class _Shapes(TorchFunctionMode):
    """Records the shape of every tensor a torch call returns."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


@pytest.mark.parametrize("arch", ARCHS)
def test_no_one_hot_dispatch_tensor(arch):
    """No tensor of ``[E, T, C]``'s or ``[T, C, E]``'s shape (in any order)
    appears: the dispatch and combine are index operations."""
    cfg, _, _, pt = _params(arch)
    n_tok = 48  # no width of the smoke models (64, 128) is T or C
    _, xt = both(randn(9, (2, n_tok // 2, cfg.d_model)))
    ne, cap = cfg.moe_num_experts, tfm.moe_capacity(cfg, n_tok)
    with _Shapes() as mode:
        tfm.moe_apply(cfg, pt, xt)
    assert mode.shapes  # the mode saw the calls
    assert sorted((ne, n_tok, cap)) not in [sorted(s) for s in mode.shapes
                                            if len(s) == 3]
