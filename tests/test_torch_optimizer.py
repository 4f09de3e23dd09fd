"""The port's optimizer (``repro_torch.distributed.optimizer``) held against
the JAX package's on the CPU.

Inputs are made from seeds with numpy; bf16 arrays cross bit for bit
(``models.convert.to_torch``).  The reference's ``update`` runs jitted on
the same parameters and gradients, step after step (each package on its
own state).  Bounds, with the values measured on this tree (CPU, torch
2.13, JAX 0.9): the schedule within ``LR_BOUND`` = 2**-20 relative
(measured 2.1e-7: fp32 ``cos`` differs by an ulp at one step); the global
norm within ``NORM_BOUND`` = 2**-19 relative (7.4e-7: the squares sum in
another order); with fp32 accumulators the parameters bit for bit and m
and v within ``ACC_BOUND["float32"]`` = 2**-18 relative L2 (1.4e-6: ``clip
/ gnorm`` differs by an fp32 ulp, and every clipped gradient with it); with
bf16 accumulators, where that ulp now and then flips a stored bf16 m or v
and with it a parameter, m and v within 2**-10 (4.8e-4) and the parameters
within ``PARAM_BOUND["bfloat16"]`` = 2**-14 (1.5e-5: 3 elements of 10240
one bf16 ulp apart over the 4 steps).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.distributed.optimizer import AdamW as RefAdamW
from repro.distributed.optimizer import AdamWConfig as RefAdamWConfig
from repro.distributed.optimizer import cosine_schedule as ref_cosine
from repro.models.common import ParamSpec as RefParamSpec
from repro_torch.core.tree import tree_flatten_with_path
from repro_torch.distributed import optimizer
from repro_torch.distributed.optimizer import (
    AdamW,
    AdamWConfig,
    OptState,
    cosine_schedule,
)
from repro_torch.models.common import ParamSpec
from repro_torch.models.convert import to_torch

LR_BOUND = 2.0 ** -20
NORM_BOUND = 2.0 ** -19
ACC_BOUND = {"float32": 2.0 ** -18, "bfloat16": 2.0 ** -10}
PARAM_BOUND = {"float32": 0.0, "bfloat16": 2.0 ** -14}
SHAPES = {"a": (64, 32), "b": {"c": (128,), "d": (3, 16, 8)}}
ACC = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel_l2(got, ref) -> float:
    got, ref = f32(got), f32(ref)
    assert got.shape == ref.shape
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def draw(rng, scale, shapes=SHAPES):
    """One bf16 tree of ``shapes`` as the reference's and, bit for bit, the
    port's."""
    ref = {k: draw(rng, scale, s)[0] if isinstance(s, dict) else
           jnp.asarray(rng.standard_normal(s).astype(np.float32) * scale,
                       jnp.bfloat16) for k, s in shapes.items()}
    return ref, jax.tree_util.tree_map(lambda a: to_torch(np.asarray(a)),
                                       ref)


def pairs(port_tree, ref_tree):
    """Matching leaves of the two trees, by key string."""
    ref = {jax.tree_util.keystr(p): v
           for p, v in jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    got = dict(tree_flatten_with_path(port_tree))
    assert sorted(got) == sorted(ref)
    return [(k, got[k], ref[k]) for k in sorted(ref)]


@pytest.mark.parametrize("warmup,total", [(0, 1), (3, 10), (10, 10),
                                          (5, 100)])
def test_cosine_schedule(warmup, total):
    """Steps 0 to past ``total``: the warm-up ramp, the cosine and the
    floor, as fp32 on the step's device."""
    steps = np.arange(0, total + 6, dtype=np.int32)
    got = cosine_schedule(torch.from_numpy(steps), base_lr=3e-3,
                          warmup=warmup, total=total)
    want = ref_cosine(jnp.asarray(steps), base_lr=3e-3, warmup=warmup,
                      total=total)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LR_BOUND,
                               atol=0)
    assert float(got[-1]) == pytest.approx(3e-4, rel=1e-6)  # the floor


@pytest.mark.parametrize("acc", list(ACC))
@pytest.mark.parametrize("with_residual", [False, True])
def test_update_against_the_reference(acc, with_residual):
    """Four steps of ``AdamW.update`` (clipping, warm-up and decay, weight
    decay) on the same gradients: the parameters within ``PARAM_BOUND``,
    m and v within ``ACC_BOUND``, the global norm within ``NORM_BOUND``,
    the residual passed through."""
    rng = np.random.default_rng(0)
    jdt, tdt = ACC[acc]
    kw = dict(base_lr=1e-2, warmup=2, total_steps=10)
    ref_opt = RefAdamW(RefAdamWConfig(acc_dtype=jdt, **kw))
    opt = AdamW(AdamWConfig(acc_dtype=tdt, **kw))
    rp, tp = draw(rng, 0.1)
    rs, ts = ref_opt.init(rp), opt.init(tp)
    assert int(ts.step) == 0 and ts.step.dtype == torch.int32
    assert ts.residual is None
    for _, m, _ in pairs(ts.m, rs.m):
        assert m.dtype == tdt and not bool(m.any())
    update = jax.jit(ref_opt.update)
    for step in range(4):
        rg, tg = draw(rng, 2.0 if step % 2 else 1e-3)  # clipped, then not
        rr, tr = draw(rng, 0.01) if with_residual else (None, None)
        rp, rs, rn = update(rp, rs, rg, rr)
        tp2, ts, tn = opt.update(tp, ts, tg, tr)
        assert tp2 is tp
        assert isinstance(ts, OptState) and int(ts.step) == step + 1
        assert tn.dtype == torch.float32 and tn.shape == ()
        assert rel_l2(tn, rn) <= NORM_BOUND
        for key, got, want in pairs(tp, rp):
            assert got.dtype == torch.bfloat16
            assert rel_l2(got, want) <= PARAM_BOUND[acc], key
        for part in ("m", "v"):
            for key, got, want in pairs(getattr(ts, part),
                                        getattr(rs, part)):
                assert got.dtype == tdt
                assert rel_l2(got, want) <= ACC_BOUND[acc], (part, key)
        if with_residual:
            assert ts.residual is tr
        else:
            assert ts.residual is None


def test_init_with_residual_and_state_specs():
    """``init``'s per-replica residuals and ``state_specs``' trees have
    the reference's shapes, logical names and dtypes."""
    rng = np.random.default_rng(1)
    rp, tp = draw(rng, 0.1)
    rs = RefAdamW().init(rp, with_residual=True, replicas=3)
    ts = AdamW().init(tp, with_residual=True, replicas=3)
    for key, got, want in pairs(ts.residual, rs.residual):
        assert tuple(got.shape) == want.shape
        assert got.dtype == torch.bfloat16 and not bool(got.any())

    def specs(cls, shapes=SHAPES):
        return {k: specs(cls, s) if isinstance(s, dict) else
                cls(s, tuple(f"d{i}" for i in range(len(s))))
                for k, s in shapes.items()}

    ref = RefAdamW(RefAdamWConfig(acc_dtype=jnp.bfloat16)).state_specs(
        specs(RefParamSpec), with_residual=True, replicas=2)
    got = AdamW(AdamWConfig(acc_dtype=torch.bfloat16)).state_specs(
        specs(ParamSpec), with_residual=True, replicas=2)
    assert got.step.shape == () and got.step.dtype == torch.int32
    for part in ("m", "v", "residual"):
        for key, g, r in pairs(getattr(got, part), getattr(ref, part)):
            assert (g.shape, g.names, g.init) == (r.shape, r.names, r.init)
            assert str(g.dtype).removeprefix("torch.") == np.dtype(
                r.dtype).name, (part, key)


def test_update_makes_no_host_sync_and_stays_on_the_device():
    """The schedule, the bias corrections and the clip are tensors: the
    update returns device tensors (0-d norm, int32 step), never Python
    numbers."""
    rng = np.random.default_rng(2)
    _, tp = draw(rng, 0.1)
    _, tg = draw(rng, 1.0)
    opt = AdamW()
    _, st, gn = opt.update(tp, opt.init(tp), tg)
    assert isinstance(gn, torch.Tensor) and isinstance(st.step, torch.Tensor)
    assert st.step.dtype == torch.int32 and gn.device == st.step.device


@pytest.mark.parametrize("acc", list(ACC))
def test_project_keeps_a_stepped_state_and_lifts_a_lossy_one(acc):
    """``AdamW.project`` (the port's, for restored states) leaves a state
    that steps made bit for bit as it is; on a state whose v came back
    negative or near zero it lifts v to ``(m / C)**2``, and the next step
    is finite and within ``C * sqrt(1 - b2**t) / (1 - b1**t)`` of ``lr``
    per element, beside the weight decay."""
    tdt = ACC[acc][1]
    opt = AdamW(AdamWConfig(base_lr=1e-2, warmup=1, total_steps=10,
                            weight_decay=0.0, acc_dtype=tdt))
    rng = np.random.default_rng(3)
    _, tp = draw(rng, 0.1)
    st = opt.init(tp)
    for _ in range(5):
        _, tg = draw(rng, 1.0)
        _, st, _ = opt.update(tp, st, tg)
    before = [t.clone() for t in jax.tree_util.tree_leaves(st.v)]
    opt.project(st)
    for got, want in zip(jax.tree_util.tree_leaves(st.v), before):
        assert torch.equal(got, want)
    # a lossy restore: v negative or tiny in a third of the entries
    for v in jax.tree_util.tree_leaves(st.v):
        flat = v.view(-1)
        flat[::3] = torch.where(torch.arange(flat[::3].numel()) % 2 == 0,
                                -flat[::3], flat[::3] * 1e-12).to(tdt)
    opt.project(st)
    c = opt.config
    c2 = (1 - c.b1) ** 2 / ((1 - c.b2) * (1 - c.b1 ** 2 / c.b2))
    for m, v in zip(jax.tree_util.tree_leaves(st.m),
                    jax.tree_util.tree_leaves(st.v)):
        assert bool((v.float() >= 0).all())
        assert bool((m.float() ** 2 <= c2 * v.float() * 1.05).all())
    start = [p.float().clone() for p in jax.tree_util.tree_leaves(tp)]
    _, tg = draw(rng, 1e-6)  # a small gradient: m and v dominate
    _, st, _ = opt.update(tp, st, tg)
    t = int(st.step)
    bound = c.base_lr * (c2 ** 0.5) * (1 - c.b2 ** t) ** 0.5 / (
        1 - c.b1 ** t)
    for p, p0 in zip(jax.tree_util.tree_leaves(tp), start):
        step = (p.float() - p0).abs()
        ulp = p0.abs() * 2.0 ** -7  # the bf16 weight's own rounding
        assert bool(torch.isfinite(p.float()).all())
        assert bool((step <= bound * 1.05 + ulp).all()), float(
            (step - ulp).max())


@pytest.mark.parametrize("acc", list(ACC))
def test_update_in_slices_is_the_whole_update(acc, monkeypatch):
    """``AdamW.update`` walks each leaf in slices of ``UPDATE_SLICE``
    elements (its fp32 temporaries stay small beside a large state): with
    slices of 7 elements, which cut every leaf of ``SHAPES`` with a short
    last slice, the parameters, m and v after 3 steps are bit for bit the
    whole-leaf update's."""
    tdt = ACC[acc][1]
    opt = AdamW(AdamWConfig(base_lr=1e-2, warmup=1, total_steps=10,
                            acc_dtype=tdt))
    rng = np.random.default_rng(4)
    _, start = draw(rng, 0.1)
    grads = [draw(rng, 2.0 if i % 2 else 1e-3)[1] for i in range(3)]
    arms = []
    for slice_len in (optimizer.UPDATE_SLICE, 7):
        monkeypatch.setattr(optimizer, "UPDATE_SLICE", slice_len)
        tp = jax.tree_util.tree_map(torch.clone, start)
        st = opt.init(tp)
        for g in grads:
            _, st, _ = opt.update(tp, st, g)
        arms.append([*jax.tree_util.tree_leaves(tp),
                     *jax.tree_util.tree_leaves(st.m),
                     *jax.tree_util.tree_leaves(st.v)])
    for whole, sliced in zip(*arms):
        assert torch.equal(whole, sliced)
