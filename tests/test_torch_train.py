"""The port's training path (M10b: ``Model.loss`` under autograd, the train
step, AdamW) held against the JAX package on the CPU.

The reference's ``make_train_step`` fails on the installed JAX (R4), so the
oracle is single-process math: ``jax.jit(jax.value_and_grad(model.loss))``
and ``AdamW.update``, as ``tests/test_checkpoint.py`` runs them.  Inputs are
made from seeds with numpy; the reference's parameters cross bit for bit
(``params_from_jax``).  Bounds and the values measured on this tree (CPU,
torch 2.13, JAX 0.9):

* single functions' backwards: ``silu``, tanh-``gelu`` (``_SiLU``,
  ``_GELU``), attention in one query chunk, RoPE and the matmuls bit for
  bit; ``rms_norm``'s bit for bit once its two sums are taken as XLA's CPU
  lowering takes a bf16 reduction (windows of 32 in order, every partial
  sum rounded to bf16: ``xla_bf16_sum``), and within ``NORM_GRAD_BOUND`` =
  2**-6 as the port sums (fp32 accumulation, rounded once; measured
  6.6e-3); chunked
  attention (three query chunks) within ``ATTN_GRAD_BOUND`` = 2**-7
  (3.1e-3: the reference sums a chunk's k and v cotangents into bf16 across
  its scan, the port in fp32);
* the five in-slice smoke models: the loss within ``LOSS_BOUND`` = 2**-6
  relative (2 bf16 ulps, ``test_torch_models.py``'s forward bound;
  measured 0 to 1.7e-5) and every gradient leaf within ``GRAD_BOUND`` =
  2**-5 relative L2 (measured 0 to 2.2e-2, the largest in the first
  layer, where the bf16 sums' differences have passed through every
  layer's backward).  For scale: the
  reference's own bf16 gradients differ from the same math in fp32 by 0.19
  to 1.23 at their worst leaf;
* the MoE, MLA and encoder-decoder smoke models (``FAMILIES``) under the
  same two bounds: deepseek-v3 (MLA, 8 experts top 2) loss 1.6e-5, worst
  leaf ``group1.ln1`` 0.0229; llama4-scout (4 experts top 1, the shared
  expert) 9.0e-5, ``group0.ln1`` 0.0136; whisper-tiny (its layers drawn
  one at a time, as ``test_torch_models.py`` draws them) 0,
  ``decoder.attn.bq`` 0.0155.  Whisper's two key biases with no RoPE
  after them have an exact gradient of 0 and are held against their
  block's query bias instead (``bias_leaves_held``);
* remat on and off: losses and gradients bit for bit (whisper's encoder
  and decoder layers each checkpointed, as the reference's are);
* a 3-step trajectory (AdamW at lr 1e-3, warm-up 1, the reference test's
  setting) on granite, gemma2 (tied embeddings, softcaps), internvl2
  (the patch prefix), deepseek-v3 and whisper-tiny: each step's loss
  within ``TRAJ_LOSS_BOUND`` = 2**-8 relative (measured up to 7.9e-4),
  and the parameters' change over the three steps, over all leaves,
  within ``TRAJ_CHANGE_BOUND`` = 2**-2 relative L2 (measured 0.084 to
  0.147).  Adam's first step is ``lr *
  sign(g)``: an element whose gradient sits at rounding-noise level moves
  by ``±lr`` whichever package computes it, and a bf16 weight near 0.1
  moves by one or two ulps a step.  The count of elements whose change
  disagrees in sign is reported in the assertion message, not bounded
  (measured up to 1.9% of a leaf); nor are the later steps' gradient
  norms (which the clip to 1.0 takes out of the update; 4% and 20% apart
  at step 1 on granite and gemma2).
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke
from repro.distributed.optimizer import AdamW as RefAdamW
from repro.distributed.optimizer import AdamWConfig as RefAdamWConfig
from repro.models import build_model as ref_build_model
from repro.models import common as ref_common
from repro.models import transformer as ref_tfm
from repro.models.common import init_params as ref_init_params
from repro_torch.configs import get_smoke
from repro_torch.distributed.optimizer import AdamW, AdamWConfig
from repro_torch.distributed.train import TrainStep, make_train_step
from repro_torch.models import build_model
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_jax, to_torch
from test_torch_models import PER_LAYER_DRAW, per_layer_params

LOSS_BOUND = 2.0 ** -6
GRAD_BOUND = 2.0 ** -5
NORM_GRAD_BOUND = 2.0 ** -6
ATTN_GRAD_BOUND = 2.0 ** -7
TRAJ_LOSS_BOUND = 2.0 ** -8
TRAJ_CHANGE_BOUND = 2.0 ** -2
IN_SLICE = ("granite_8b", "minitron_4b", "gemma2_27b", "qwen15_4b",
            "internvl2_26b")
# the MoE, MLA and encoder-decoder families (M10c training, first half)
FAMILIES = ("deepseek_v3_671b", "llama4_scout_17b_a16e", "whisper_tiny")
TRAJECTORY = ("granite_8b", "gemma2_27b", "internvl2_26b",
              "deepseek_v3_671b", "whisper_tiny")
# whisper's key biases where no RoPE follows them (the encoder's
# self-attention, the cross-attention): exact gradient 0; each is held
# against its block's query bias (``bias_leaves_held``)
ZERO_GRAD = {"encoder.attn.bk": "encoder.attn.bq",
             "decoder.cross.bk": "decoder.cross.bq"}


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel_l2(got, ref) -> float:
    got, ref = f32(got), f32(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def randn(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def vjp_both(ref_fn, port_fn, arrays, cot_shape):
    """The cotangents of ``arrays`` (bf16, bit-equal in both packages)
    under one seeded bf16 cotangent: ``(port's, reference's)``."""
    ref_in = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    port_in = [to_torch(np.asarray(a)).requires_grad_(True) for a in ref_in]
    ct = jnp.asarray(randn(99, cot_shape), jnp.bfloat16)
    _, vjp = jax.vjp(jax.jit(ref_fn), *ref_in)
    want = jax.jit(vjp)(ct)
    port_fn(*port_in).backward(to_torch(np.asarray(ct)))
    return [t.grad for t in port_in], want


def xla_bf16_sum(t: torch.Tensor, dim: int, window: int = 32
                 ) -> torch.Tensor:
    """A bf16 ``lax.reduce_sum`` as XLA's CPU lowering computes it: the
    axis cut into windows of 32 (its tree-reduction rewriter's
    reduce-window), each window summed in order, then the windows' sums in
    order, every partial sum rounded to bf16."""
    def in_order(rows):
        acc = torch.zeros(rows.shape[1:])
        for row in rows:
            acc = (acc + row.float()).bfloat16().float()
        return acc

    t = t.movedim(dim, 0)
    if t.shape[0] > window:
        t = torch.stack([in_order(t[i:i + window])
                         for i in range(0, t.shape[0], window)])
    return in_order(t).bfloat16()


# ---------------------------------------------------------------------------
# Single functions.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["granite_8b", "gemma2_27b"])
def test_activation_backward_is_the_reference_s(arch):
    """``silu`` (granite) and tanh-``gelu`` (gemma2): the forward and the
    backward bit for bit."""
    cfg, ref_cfg = get_smoke(arch), ref_get_smoke(arch)
    x = randn(2, (2, 12, 128), 2.0)
    got, want = vjp_both(lambda a: ref_tfm._act(ref_cfg, a),
                         lambda a: tfm._act(cfg, a), [x], x.shape)
    assert got[0].dtype == torch.bfloat16
    assert np.array_equal(f32(got[0]), f32(want[0]))


@pytest.mark.parametrize("offset", [0.0, 1.0])
@pytest.mark.parametrize("xla_sums", [False, True])
def test_rms_norm_backward(offset, xla_sums, monkeypatch):
    """``rms_norm``'s backward: within ``NORM_GRAD_BOUND`` as the port
    sums; bit for bit with its two sums taken as XLA's CPU lowering takes
    them (the only difference)."""
    if xla_sums:
        def backward(ctx, g):
            x, weight, inv, k, w = ctx.saved_tensors
            gw = xla_bf16_sum((x * inv * g).flatten(0, -2), 0)
            gxn = g * w
            gi = xla_bf16_sum(x * gxn, -1).unsqueeze(-1).float()
            gr = gi * (-0.5 * k) / x.shape[-1]
            gx = gxn * inv + (x.float() * gr * 2).to(x.dtype)
            return gx, gw, None, None

        monkeypatch.setattr(common._RMSNorm, "backward",
                            staticmethod(backward))
    x, w = randn(0, (2, 12, 64), 3.0), randn(1, (64,), 0.1) + 1 - offset
    got, want = vjp_both(
        lambda a, b: ref_common.rms_norm(a, b, offset=offset),
        lambda a, b: common.rms_norm(a, b, offset=offset), [x, w], x.shape)
    for g, r in zip(got, want):
        assert g.dtype == torch.bfloat16
        if xla_sums:
            assert np.array_equal(f32(g), f32(r))
        else:
            assert rel_l2(g, r) <= NORM_GRAD_BOUND


ATTENTION = {
    "one_chunk": (12, 1024, {}),
    "one_chunk_window_softcap": (12, 1024, dict(window=5, softcap=50.0)),
    "three_chunks": (21, 8, {}),
    "three_chunks_window_softcap": (21, 8, dict(window=5, softcap=50.0)),
}


@pytest.mark.parametrize("case", list(ATTENTION))
def test_attention_backward(case):
    """Attention fills its fp32 scores in place (``masked_fill_``); its
    gradients are the reference's: bit for bit in one query chunk, within
    ``ATTN_GRAD_BOUND`` over three."""
    s, chunk, kw = ATTENTION[case]
    arrays = [randn(3, (2, s, 4, 16)), randn(4, (2, s, 2, 16)),
              randn(5, (2, s, 2, 16))]
    got, want = vjp_both(
        lambda q, k, v: ref_common.attention(q, k, v, q_chunk=chunk, **kw),
        lambda q, k, v: common.attention(q, k, v, q_chunk=chunk, **kw),
        arrays, (2, s, 4, 16))
    for g, r in zip(got, want):
        if chunk >= s:
            assert np.array_equal(f32(g), f32(r))
        else:
            assert rel_l2(g, r) <= ATTN_GRAD_BOUND


# ---------------------------------------------------------------------------
# The five in-slice smoke models: loss and gradients.
# ---------------------------------------------------------------------------
def ref_model(arch: str, key: int = 2):
    """The reference's smoke model and its parameters; whisper's drawn a
    layer at a time (``test_torch_models.PER_LAYER_DRAW``: the stacked
    draw's chaotic weights, R7, move its loss 1.5e-3 and its encoder's
    gradients 0.4 relative on a single rounding in another order)."""
    m = ref_build_model(ref_get_smoke(arch))
    init = per_layer_params if arch in PER_LAYER_DRAW else ref_init_params
    return m, init(m.param_specs(), jax.random.PRNGKey(key))


def port_model(arch: str, params) -> torch.nn.Module:
    model = build_model(get_smoke(arch), device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, params), model)
    return model


def batch(cfg, seed: int, b: int = 2, s: int = 12, labels="random"):
    """Seeded tokens (labels random, or the tokens themselves), the VLM's
    patch embeddings at 0.01 and the audio family's frames N(0, 1) in
    bf16: ``(reference's, port's)``."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lab = tokens if labels == "tokens" else rng.integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    ref = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(lab)}
    port = {"tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(lab)}
    if cfg.family == "vlm":
        pe = np.full((b, cfg.vision_prefix, cfg.d_model), 0.01, np.float32)
        ref["patch_embeds"] = jnp.asarray(pe, jnp.bfloat16)
        port["patch_embeds"] = to_torch(np.asarray(ref["patch_embeds"]))
    if cfg.family == "audio":
        fr = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model))
        ref["frames"] = jnp.asarray(fr.astype(np.float32), jnp.bfloat16)
        port["frames"] = to_torch(np.asarray(ref["frames"]))
    return ref, port


def port_grads(model, b, remat=True):
    """The loss and ``{name: gradient}`` of ``model`` on batch ``b``."""
    model.requires_grad_(True)
    loss = model.loss(b, remat=remat)
    names, params = zip(*model.named_parameters())
    return loss, dict(zip(names, torch.autograd.grad(loss, params)))


def is_stack(head: str) -> bool:
    """Whether a top-level key of the reference's tree is a stack of
    layers (its leaves ``[L, ...]``, one port module a layer)."""
    return head.startswith("group") or head in ("encoder", "decoder",
                                                 "layers")


def stacked(by_name, tree_path, layers):
    """The port's per-layer tensors of one reference leaf, stacked."""
    head, rest = tree_path[0], tree_path[1:]
    if not is_stack(head):
        return by_name[head]
    return torch.stack([by_name[".".join((head, str(i)) + rest)]
                        for i in range(layers)])


def leaf_pairs(by_name, tree):
    """``(dotted path, port's stacked leaf, reference's leaf)`` of every
    leaf of the reference's ``tree``."""
    for path, want in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(k.key for k in path)
        depth = want.shape[0] if is_stack(keys[0]) else 1
        yield ".".join(keys), stacked(by_name, keys, depth), want


@functools.lru_cache(maxsize=None)
def grads_both(arch: str):
    rm, params = ref_model(arch)
    rb, pb = batch(ref_get_smoke(arch), 0)
    rl, rg = jax.jit(jax.value_and_grad(rm.loss))(params, rb)
    loss, g = port_grads(port_model(arch, params), pb)
    return loss, rl, g, rg


def bias_leaves_held(pairs) -> None:
    """Whisper's two key biases with no RoPE after them: a key bias adds
    ``q . b`` to every score of a query's row, which its softmax does not
    see, so the exact gradient is 0 and both packages return rounding
    noise, where a relative L2 means nothing (the smoke model: the
    reference's ``encoder.attn.bk`` gradient has norm 2.6e-4 beside
    ``bq``'s 8.0e-2, the port's 7.0e-5; ``decoder.cross.bk`` 1.2e-4 and
    2.7e-5 beside 2.3e-2; relative L2 1.04 and 1.06).  Each package's is
    held at
    ``|g_bk| <= GRAD_BOUND * |g_bq|`` of the same block; the decoder's
    self-attention ``bk``, which RoPE follows, is held as every other leaf
    is."""
    for bk, bq in ZERO_GRAD.items():
        for got, want in ((pairs[bk][0], pairs[bq][0]),
                          (pairs[bk][1], pairs[bq][1])):
            assert (np.linalg.norm(f32(got))
                    <= GRAD_BOUND * np.linalg.norm(f32(want))), bk


def held_to_reference(arch: str, loss, rl, g, rg) -> None:
    """The port's loss within ``LOSS_BOUND`` and every gradient leaf within
    ``GRAD_BOUND`` of the reference's, each leaf in its own dtype."""
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - float(rl)) <= LOSS_BOUND * abs(float(rl))
    pairs = {name: (got, want) for name, got, want in leaf_pairs(g, rg)}
    assert len(g) == sum(got.shape[0] if is_stack(name.split(".")[0])
                         else 1 for name, (got, _) in pairs.items())
    if get_smoke(arch).family == "audio":
        bias_leaves_held(pairs)
    for name, (got, want) in pairs.items():
        assert str(got.dtype) == f"torch.{want.dtype}", name  # bf16; routers f32
        if name not in ZERO_GRAD:
            assert rel_l2(got, want) <= GRAD_BOUND, name


@pytest.mark.parametrize("arch", IN_SLICE + FAMILIES)
def test_loss_and_gradients(arch):
    held_to_reference(arch, *grads_both(arch))


@pytest.mark.parametrize("arch", ["granite_8b", "gemma2_27b",
                                  "internvl2_26b"] + list(FAMILIES))
def test_remat_changes_nothing(arch):
    """Per-layer activation checkpointing on and off: the loss and every
    gradient bit for bit; and the loss's forward under autograd is the
    serving forward's."""
    _, params = ref_model(arch)
    _, pb = batch(ref_get_smoke(arch), 1)
    model = port_model(arch, params)
    with torch.no_grad():
        plain = model.loss(pb)
    a_loss, a = port_grads(model, pb, remat=True)
    b_loss, b = port_grads(model, pb, remat=False)
    assert torch.equal(a_loss, b_loss) and torch.equal(a_loss, plain)
    for name in a:
        assert torch.equal(a[name], b[name]), name


# ---------------------------------------------------------------------------
# Trajectories, memorization, no NaNs.
# ---------------------------------------------------------------------------
TRAJ_OPT = dict(base_lr=1e-3, warmup=1, total_steps=20)


@functools.lru_cache(maxsize=None)
def trajectories(arch: str, steps: int = 3):
    """``steps`` AdamW steps from the reference's weights in each package,
    batch ``i`` drawn from seed ``i`` (tokens as labels): per-step (loss,
    grad norm) and the final and initial parameters, stacked in the
    reference's layout."""
    rm, params = ref_model(arch)
    ref_opt = RefAdamW(RefAdamWConfig(**TRAJ_OPT))

    @jax.jit
    def ref_step(p, st, b):
        loss, g = jax.value_and_grad(rm.loss)(p, b)
        p2, st2, gn = ref_opt.update(p, st, g)
        return p2, st2, loss, gn

    model = port_model(arch, params)
    ts = make_train_step(model, AdamW(AdamWConfig(**TRAJ_OPT)), "cpu")
    assert isinstance(ts, TrainStep) and ts.compressor is None
    p, st, pst = params, ref_opt.init(params), ts.init()
    ref_out, port_out = [], []
    for i in range(steps):
        rb, pb = batch(ref_get_smoke(arch), i, s=16, labels="tokens")
        p, st, loss, gn = ref_step(p, st, rb)
        ref_out.append((float(loss), float(gn)))
        pst, metrics = ts.step_fn(pst, pb)
        assert metrics["loss"].shape == () and metrics["grad_norm"].shape == ()
        port_out.append((float(metrics["loss"]),
                         float(metrics["grad_norm"])))
    assert int(pst.step) == steps
    named = {n: t.detach() for n, t in model.named_parameters()}
    return port_out, ref_out, named, p, params


def trajectory_held(arch: str) -> None:
    """``trajectories(arch)``: each step's loss within ``TRAJ_LOSS_BOUND``,
    the parameters' change within ``TRAJ_CHANGE_BOUND``."""
    port_out, ref_out, named, final, initial = trajectories(arch)
    for (pl, _), (rl, _) in zip(port_out, ref_out):
        assert abs(pl - rl) <= TRAJ_LOSS_BOUND * abs(rl), (port_out, ref_out)
    d_port, d_ref, flips = [], [], {}
    for (name, got, want), (_, start) in zip(
            leaf_pairs(named, final),
            jax.tree_util.tree_flatten_with_path(initial)[0]):
        dp, dr = f32(got) - f32(start), f32(want) - f32(start)
        d_port.append(dp.ravel())
        d_ref.append(dr.ravel())
        flips[name] = int((np.sign(dp) != np.sign(dr)).sum())
    dp, dr = np.concatenate(d_port), np.concatenate(d_ref)
    change = float(np.linalg.norm(dp - dr) / np.linalg.norm(dr))
    assert change <= TRAJ_CHANGE_BOUND, (change, flips)


@pytest.mark.parametrize("arch", TRAJECTORY)
def test_three_step_trajectory(arch):
    trajectory_held(arch)


def test_memorizes_one_batch():
    """The twin of ``test_distributed.py::test_train_step_single_device_
    mesh``: 15 steps on one repeated batch; the last loss is below 0.7 x
    the first."""
    cfg = get_smoke("granite_8b")
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    ts = make_train_step(model, AdamW(AdamWConfig(
        base_lr=3e-3, warmup=2, total_steps=40)), "cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)))
    st, losses = ts.init(), []
    for _ in range(15):
        st, metrics = ts.step_fn(st, {"tokens": tokens, "labels": tokens})
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses


@pytest.mark.parametrize("arch", IN_SLICE)
def test_smoke_train_step_no_nans(arch):
    """The twin of ``test_archs.py::test_smoke_train_step_no_nans``: one
    step from seeded weights; the loss, the norm and every updated weight
    finite."""
    cfg = get_smoke(arch)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    ts = make_train_step(model, AdamW(AdamWConfig(
        base_lr=1e-3, warmup=1, total_steps=10)), "cpu")
    _, b = batch(cfg, 0, b=2, s=8)
    st, metrics = ts.step_fn(ts.init(), b)
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    for name, p in model.named_parameters():
        assert bool(torch.isfinite(p.float()).all()), name
