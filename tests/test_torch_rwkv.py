"""The port's RWKV-6 layer (``repro_torch.models.rwkv``) held against the
JAX package on the CPU.

Inputs and weights are made from numpy seeds and cross bit for bit (bf16
through its pattern).  The leaves whose inits are zeros or ones are drawn
away from them, so the token-shift mixes, the decay and the bonus vary by
channel: the mixes N(0, 1), ``w_base`` N(-1, 0.5) (decays about 0.4-0.9
a step), ``u`` N(0, 0.5), the norms' weights 1 + N(0, 0.1); the matrices
at their spec's std.  Every output is held in relative L2 to ``BOUND =
2**-6`` (2 bf16 ulps), the fp32 wkv state included.  The port's wkv
recurrence forms each step's ``k^T v`` and its bonus ``(r . (u o k)) v``
before the loop and adds ``r S`` to the bonus, where the reference sums
``r (S + u k^T v)``: the same terms in another fp32 order.  Measured on
this tree (CPU, torch 2.13, JAX 0.9), from zero or carried states: the
train path's output 0 at S = 40 and 2.9e-4 at S = 256 (the reference's
chunked scan; one bf16 rounding of the output in another fp32 order),
its shifts 0 and its wkv state 4.4e-8 and 8.1e-8; one decode step on the
reference's state 0, its wkv 2.2e-8; S = 24 decode steps from zero
states against the reference's train path 3.3e-4 (outputs), the final
shifts 0 and wkv 4.4e-8.
"""
import pytest

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke
from repro.models import rwkv as ref_rwkv
from repro_torch.configs import get_smoke
from repro_torch.models import rwkv
from test_torch_models import BOUND, both, dtype_name, randn, rel_l2

ARCH = "rwkv6_3b"  # smoke: d 64, 4 heads of 16, d_ff 128
B = 2
SCALE = {"w_base": 0.5, "u": 0.5}  # the rest: mixes 1, norms 0.1
SHIFT = {"w_base": -1.0}


def _leaf(name: str, spec, seed: int):
    if spec.init == "normal":
        return randn(seed, spec.shape, spec.std)
    if spec.init == "ones":
        return 1.0 + randn(seed, spec.shape, 0.1)
    scale = SCALE.get(name, 1.0)
    return randn(seed, spec.shape, scale) + SHIFT.get(name, 0.0)


def _params(seed: int = 7):
    """One layer's weights in both packages (``rwkv_layer_specs``)."""
    cfg = get_smoke(ARCH)
    pj, pt = {}, {}
    for i, (name, spec) in enumerate(sorted(
            _flat(rwkv.rwkv_layer_specs(cfg)).items())):
        dtype = jnp.float32 if spec.dtype == torch.float32 else jnp.bfloat16
        a, t = both(_leaf(name.split(".")[-1], spec, seed + i), dtype)
        _put(pj, name, a)
        _put(pt, name, t)
    return cfg, ref_get_smoke(ARCH), pj, pt


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _put(tree, dotted: str, leaf):
    *path, last = dotted.split(".")
    for k in path:
        tree = tree.setdefault(k, {})
    tree[last] = leaf


def _state(cfg, seed: int):
    """A carried (shift1, shift2, wkv) in both packages."""
    h, hd = rwkv.rwkv_heads(cfg)
    s1 = both(randn(seed, (B, cfg.d_model)))
    s2 = both(randn(seed + 1, (B, cfg.d_model)))
    wkv = both(randn(seed + 2, (B, h, hd, hd), 0.5), jnp.float32)
    return tuple(x[0] for x in (s1, s2, wkv)), tuple(x[1] for x in
                                                     (s1, s2, wkv))


def test_specs_match_the_reference():
    cfg, ref_cfg, _, _ = _params()
    assert rwkv.rwkv_heads(cfg) == ref_rwkv.rwkv_heads(ref_cfg) == (4, 16)
    mine = _flat(rwkv.rwkv_layer_specs(cfg))
    ref = _flat(ref_rwkv.rwkv_layer_specs(ref_cfg))
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert (mine[k].shape, mine[k].names, mine[k].init, mine[k].scale,
                dtype_name(mine[k].dtype)) == (
            ref[k].shape, ref[k].names, ref[k].init, ref[k].scale,
            dtype_name(ref[k].dtype)), k


def test_time_mix_inputs():
    """r, k, v, g in bf16 and the decay in fp32, each at the reference's
    value; the decay varies by channel."""
    cfg, ref_cfg, pj, pt = _params()
    xj, xt = both(randn(1, (B, 21, cfg.d_model)))
    pj_, pt_ = both(randn(2, (B, cfg.d_model)))
    got = rwkv._time_mix_inputs(pt["tm"], xt, pt_)
    want = ref_rwkv._time_mix_inputs(ref_cfg, pj["tm"], xj, pj_)
    assert [t.dtype for t in got] == [torch.bfloat16] * 4 + [torch.float32]
    for g, w in zip(got, want):
        assert rel_l2(g, w) <= BOUND
    w = got[-1]
    assert 0 < float(w.min()) < 0.3 and 0.7 < float(w.max()) < 1


@pytest.mark.parametrize("s", [40, 256])  # 256: the reference's chunked scan
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_rwkv_layer_train(s, carried):
    """The output and the (shift1, shift2, wkv) after S tokens, from zero
    states or from a carried one."""
    cfg, ref_cfg, pj, pt = _params()
    xj, xt = both(randn(3, (B, s, cfg.d_model)))
    sj, st = _state(cfg, 4) if carried else (None, None)
    got, got_state = rwkv.rwkv_layer_train(cfg, pt, xt, st)
    want, want_state = ref_rwkv.rwkv_layer_train(ref_cfg, pj, xj, sj)
    assert got.dtype == torch.bfloat16 and got.shape == (B, s, cfg.d_model)
    assert rel_l2(got, want) <= BOUND
    assert [t.dtype for t in got_state] == [torch.bfloat16, torch.bfloat16,
                                            torch.float32]
    for g, w in zip(got_state, want_state):
        assert tuple(g.shape) == w.shape
        assert rel_l2(g, w) <= BOUND


def test_rwkv_layer_decode():
    """One step on the reference's own state after 40 tokens."""
    cfg, ref_cfg, pj, pt = _params()
    xj, _ = both(randn(5, (B, 40, cfg.d_model)))
    _, state = ref_rwkv.rwkv_layer_train(ref_cfg, pj, xj)
    x1j, x1t = both(randn(6, (B, 1, cfg.d_model)))
    carried = tuple(both(np.asarray(t), t.dtype)[1] for t in state)
    got, got_state = rwkv.rwkv_layer_decode(cfg, pt, x1t, carried)
    want, want_state = ref_rwkv.rwkv_layer_decode(ref_cfg, pj, x1j, state)
    assert rel_l2(got, want) <= BOUND
    for g, w in zip(got_state, want_state):
        assert rel_l2(g, w) <= BOUND


def test_decode_steps_are_the_train_path():
    """S decode steps from zero states, one token each: the outputs are
    the reference's train path's, the final states its."""
    cfg, ref_cfg, pj, pt = _params()
    s = 24
    h, hd = rwkv.rwkv_heads(cfg)
    xj, xt = both(randn(8, (B, s, cfg.d_model)))
    want, want_state = ref_rwkv.rwkv_layer_train(ref_cfg, pj, xj)
    state = (torch.zeros((B, cfg.d_model), dtype=torch.bfloat16),
             torch.zeros((B, cfg.d_model), dtype=torch.bfloat16),
             torch.zeros((B, h, hd, hd), dtype=torch.float32))
    outs = []
    for i in range(s):
        y, state = rwkv.rwkv_layer_decode(cfg, pt, xt[:, i:i + 1], state)
        outs.append(y)
    assert rel_l2(torch.cat(outs, 1), want) <= BOUND
    for g, w in zip(state, want_state):
        assert rel_l2(g, w) <= BOUND


def test_a_step_is_two_launches_of_the_loop():
    """The recurrence's loop runs one batched ``r S`` product and one fused
    multiply-add a step: counted here as the ops the loop dispatches."""
    cfg, _, _, pt = _params()
    h, hd = rwkv.rwkv_heads(cfg)
    s = 2 * rwkv.SCAN_CHUNK + 3  # two whole chunks and a remainder
    args = [torch.randn(B, s, h, hd) for _ in range(4)]
    args[3] = torch.rand(B, s, h, hd)
    calls = []

    class Count(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, a=(), kw=None):
            calls.append(getattr(func, "__name__", str(func)))
            return func(*a, **(kw or {}))

    with Count():
        rwkv._wkv(*args, pt["tm"]["u"], torch.zeros(B, h, hd, hd))
    # views launch nothing: a chunk's steps are slices or unbind outputs
    ops = [c for c in calls if c not in ("__getitem__", "unbind")]
    assert (ops.count("matmul"), ops.count("addcmul")) == (s, s)
    assert len(ops) - 2 * s <= 8 * 3 + 12, ops  # a few ops a chunk
