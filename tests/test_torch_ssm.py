"""The port's Mamba block (``repro_torch.models.ssm``, the SSM half of
hymba) held against the JAX package on the CPU.

Inputs and weights are made from numpy seeds and cross bit for bit (bf16
through its pattern); ``A_log``, ``dt_bias`` and ``D`` are drawn away from
their zero/one inits so the decay and the skip vary by channel.  Every
output is held in relative L2 to ``BOUND = 2**-6`` (2 bf16 ulps), the fp32
SSM state included.  Measured on this tree (CPU, torch 2.13, JAX 0.9):
the train path 6.6e-5 (S = 40) and 1.8e-7 (S = 256), the prefill output
1.7e-9, its conv state 0 (bit-equal) and final state 6.9e-8, one decode
step's output and conv state 0 and its state 4.7e-8 (fp32 sums in another
order); S decode steps against the reference's train path 3.6e-3 and
6.1e-3 (the decode conv sums its 4 taps in fp32 and rounds once, as the
reference's einsum does; the train conv rounds each tap's product and sum
to bf16, as its Python ``sum`` does: R11, pinned below), their final
state 6.8e-3.
"""
import pytest

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_smoke
from repro_torch.models import ssm
from test_torch_models import BOUND, both, dtype_name, randn, rel_l2

ARCH = "hymba_15b"  # d 64, d_in 128, dt_rank 4, N 4, conv 4
B = 2


def _params(seed: int = 5):
    """The block's weights in both packages: normal leaves at their
    spec's std, ``A_log`` and ``dt_bias`` N(0, 0.5), ``D`` 1 + N(0, 0.1),
    ``conv_b`` N(0, 0.1)."""
    cfg = get_smoke(ARCH)
    pj, pt = {}, {}
    for i, (name, s) in enumerate(sorted(ssm.mamba_specs(cfg).items())):
        scale = {"A_log": 0.5, "dt_bias": 0.5, "D": 0.1,
                 "conv_b": 0.1}.get(name, s.std)
        arr = randn(seed + i, s.shape, scale)
        if name == "D":
            arr = arr + 1.0
        dtype = jnp.float32 if s.dtype == torch.float32 else jnp.bfloat16
        pj[name], pt[name] = both(arr, dtype)
    return cfg, ref_get_smoke(ARCH), pj, pt


def test_specs_match_the_reference():
    cfg, ref_cfg, _, _ = _params()
    assert ssm._dims(cfg) == ref_ssm._dims(ref_cfg) == (128, 4, 4, 4)
    mine, ref = ssm.mamba_specs(cfg), ref_ssm.mamba_specs(ref_cfg)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert (mine[k].shape, mine[k].names, mine[k].init,
                dtype_name(mine[k].dtype)) == (
            ref[k].shape, ref[k].names, ref[k].init,
            dtype_name(ref[k].dtype)), k


def test_ssm_inputs_and_causal_conv():
    cfg, ref_cfg, pj, pt = _params()
    xj, xt = both(randn(1, (B, 21, 128)))
    got = ssm._causal_conv(pt, xt, 4)
    assert got.dtype == torch.bfloat16
    assert rel_l2(got, ref_ssm._causal_conv(pj, xj, 4)) <= BOUND
    for g, w in zip(ssm._ssm_inputs(cfg, pt, xt),
                    ref_ssm._ssm_inputs(ref_cfg, pj, xj)):
        assert g.dtype == torch.float32
        assert rel_l2(g, w) <= BOUND


@pytest.mark.parametrize("s", [40, 256])  # 256: the reference's chunked scan
def test_mamba_apply_train(s):
    cfg, ref_cfg, pj, pt = _params()
    xj, xt = both(randn(2, (B, s, cfg.d_model)))
    got = ssm.mamba_apply_train(cfg, pt, xt)
    assert got.dtype == torch.bfloat16 and got.shape == (B, s, cfg.d_model)
    assert rel_l2(got, ref_ssm.mamba_apply_train(ref_cfg, pj, xj)) <= BOUND


def test_mamba_prefill_state():
    """The output, the last k-1 pre-conv activations (bf16) and the fp32
    final state."""
    cfg, ref_cfg, pj, pt = _params()
    xj, xt = both(randn(3, (B, 40, cfg.d_model)))
    got = ssm.mamba_prefill_state(cfg, pt, xt)
    want = ref_ssm.mamba_prefill_state(ref_cfg, pj, xj)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16,
                                      torch.float32]
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert rel_l2(g, w) <= BOUND


def test_mamba_apply_decode():
    """One step on the reference's own prefilled state."""
    cfg, ref_cfg, pj, pt = _params()
    xj, _ = both(randn(3, (B, 40, cfg.d_model)))
    _, conv, state = ref_ssm.mamba_prefill_state(ref_cfg, pj, xj)
    x1j, x1t = both(randn(4, (B, 1, cfg.d_model)))
    got = ssm.mamba_apply_decode(cfg, pt, x1t, both(conv)[1],
                                 both(state, jnp.float32)[1])
    want = ref_ssm.mamba_apply_decode(ref_cfg, pj, x1j, conv, state)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert rel_l2(g, w) <= BOUND


@pytest.mark.parametrize("split", [0, 13])
def test_prefill_then_decode_steps_is_the_train_path(split):
    """``mamba_prefill_state`` on the first ``split`` tokens (none: zero
    states), then one ``mamba_apply_decode`` a token: the outputs are the
    reference's train path's, the final states its prefill's."""
    cfg, ref_cfg, pj, pt = _params()
    s = 24
    d_in, _, n, k = ssm._dims(cfg)
    xj, xt = both(randn(6, (B, s, cfg.d_model)))
    want = ref_ssm.mamba_apply_train(ref_cfg, pj, xj)
    _, want_conv, want_state = ref_ssm.mamba_prefill_state(ref_cfg, pj, xj)
    if split:
        first, conv, state = ssm.mamba_prefill_state(cfg, pt, xt[:, :split])
        outs = [first]
    else:
        conv = torch.zeros((B, k - 1, d_in), dtype=torch.bfloat16)
        state = torch.zeros((B, d_in, n), dtype=torch.float32)
        outs = []
    for i in range(split, s):
        y, conv, state = ssm.mamba_apply_decode(cfg, pt, xt[:, i:i + 1],
                                                conv, state)
        outs.append(y)
    assert rel_l2(torch.cat(outs, 1), want) <= BOUND
    assert rel_l2(conv, want_conv) <= BOUND
    assert rel_l2(state, want_state) <= BOUND


def test_prefill_and_decode_round_the_conv_differently():
    """R11, pinned: the reference's prefill conv rounds each tap's product
    and partial sum to bf16, its decode conv sums in fp32 and rounds once,
    so the last position's output of ``mamba_prefill_state`` over S tokens
    and of S - 1 tokens then one ``mamba_apply_decode`` differ (8.5e-3
    relative here, in one block: a sum that cancels loses its digits to
    the roundings).  The port keeps both roundings: its own
    prefill-to-decode difference is the reference's."""
    cfg, ref_cfg, pj, pt = _params()
    s = 40
    xj, xt = both(randn(7, (B, s, cfg.d_model)))

    def gap(mod, c, p, x):
        full = mod.mamba_prefill_state(c, p, x)[0][:, -1:]
        _, conv, state = mod.mamba_prefill_state(c, p, x[:, :s - 1])
        return full, mod.mamba_apply_decode(c, p, x[:, s - 1:], conv,
                                            state)[0]

    ref_full, ref_step = gap(ref_ssm, ref_cfg, pj, xj)
    full, step = gap(ssm, cfg, pt, xt)
    ref_gap, port_gap = rel_l2(ref_step, ref_full), rel_l2(step, full)
    assert ref_gap > BOUND / 4
    assert abs(port_gap - ref_gap) <= 0.1 * ref_gap, (port_gap, ref_gap)
    assert rel_l2(step, ref_step) <= BOUND
