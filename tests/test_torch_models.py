"""The port's LM serving path (M10a, and M10c's MoE, MLA, hybrid, RWKV and
encoder-decoder families: ``repro_torch.models``) held against the JAX
package on the CPU.

Inputs are made from seeds with numpy and cross as arrays; bf16 arrays
cross bit for bit (``models.convert.to_torch``), and the reference's
parameters are loaded into the port's model with ``params_from_jax``.
Every float output is held in relative L2 (``|got - ref| / |ref|``) to
``BOUND = 2**-6`` (2 bf16 ulps relative, about 1.6e-2), for single
functions and for the ten smoke models alike (the loss within ``BOUND``
of the reference's, relative).  Measured on this tree (CPU, torch 2.13,
JAX 0.9, the reference jitted): every single function 0 but the rope
tables (1.8e-8, one fp32 ulp of ``sin``/``cos``); the models' prefill
logits 0 to 6.5e-3 (rwkv6-3b: single bf16 roundings carried through its
state), caches 0 to 5.0e-3 (rwkv6-3b's fp32 wkv state), the four decode
steps' logits 0 to 1.33e-2 (llama4-scout's second step: single bf16
roundings in another summation order, which then spread), losses 0 to
9.0e-5.  Cache slots past the prompt are exact zeros.  The hybrid's ring
is held at S >= its window; R10 (below) pins the reference's ring after a
shorter prompt.  RWKV and whisper load per-layer draws
(``PER_LAYER_DRAW``): with the reference's stacked draw (every layer
matrix at std ``1/sqrt(2)`` for the smoke models' 2 layers, R7) whisper's
prefill logits sat 1.8e-2 from the reference's, a single rounding in
another order amplified by the chaotic weights; with per-layer draws they
read 0 (its decode steps 0 to 2.3e-4), rwkv6-3b's 6.5e-3 (its decode
steps 3.4e-3 to 7.5e-3).  Whisper's frames are N(0, 1) and its
residual norms round as the compiled reference does (R13).
"""
import functools
import math

import pytest

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCH_IDS
from repro.configs import get_arch as ref_get_arch
from repro.configs import get_smoke as ref_get_smoke
from repro.models import build_model as ref_build_model
from repro.models import common as ref_common
from repro.models import transformer as ref_tfm
from repro.models.common import init_params as ref_init_params
from repro_torch.configs import get_arch, get_smoke
from repro_torch.models import build_model
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import (
    cache_from_jax,
    params_from_jax,
    to_torch,
)

BOUND = 2.0 ** -6  # 2 bf16 ulps, relative
IN_SLICE = ("granite_8b", "minitron_4b", "gemma2_27b", "qwen15_4b",
            "internvl2_26b", "llama4_scout_17b_a16e", "deepseek_v3_671b",
            "hymba_15b", "rwkv6_3b", "whisper_tiny")
assert sorted(IN_SLICE) == sorted(ARCH_IDS)  # every family the reference has


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel_l2(got, ref) -> float:
    got, ref = f32(got), f32(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def both(arr, dtype=jnp.bfloat16):
    """One array as the reference's (``dtype``) and, bit for bit, the
    port's."""
    j = jnp.asarray(arr, dtype)
    return j, to_torch(np.asarray(j))


def randn(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Single functions.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(offset):
    xj, xt = both(randn(0, (2, 12, 64), 3.0))
    wj, wt = both(1.0 + randn(1, (64,), 0.1))
    got = common.rms_norm(xt, wt, offset=offset)
    assert got.dtype == torch.bfloat16
    assert rel_l2(got, ref_common.rms_norm(xj, wj, offset=offset)) <= BOUND


def test_layer_norm_and_dense():
    xj, xt = both(randn(0, (2, 12, 64), 3.0))
    wj, wt = both(1.0 + randn(1, (64,), 0.1))
    bj, bt = both(randn(2, (64,), 0.1))
    got = common.layer_norm(xt, wt, bt)
    assert got.dtype == torch.bfloat16
    assert rel_l2(got, ref_common.layer_norm(xj, wj, bj)) <= BOUND
    spec = common.Dense.spec(64, 32, ("hidden", "ffn"), bias=True)
    ref_spec = ref_common.Dense.spec(64, 32, ("hidden", "ffn"), bias=True)
    assert {k: (s.shape, s.names, s.init) for k, s in spec.items()} == {
        k: (s.shape, s.names, s.init) for k, s in ref_spec.items()}
    pj, pt = {}, {}
    pj["w"], pt["w"] = both(randn(3, (64, 32), spec["w"].std))
    pj["b"], pt["b"] = both(randn(4, (32,), 0.1))
    assert rel_l2(common.Dense.apply(pt, xt),
                  ref_common.Dense.apply(pj, xj)) <= BOUND


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_and_apply_rope(theta):
    sj, cj = ref_common.rope(jnp.arange(21), 16, theta)
    st, ct = common.rope(torch.arange(21), 16, theta)
    assert rel_l2(st, sj) <= BOUND and rel_l2(ct, cj) <= BOUND
    xj, xt = both(randn(2, (2, 21, 4, 16)))
    # the rotation on the reference's own tables: the two halves rotate
    got = common.apply_rope(xt, to_torch(np.asarray(sj)),
                            to_torch(np.asarray(cj)))
    assert got.dtype == torch.bfloat16
    assert rel_l2(got, ref_common.apply_rope(xj, sj, cj)) <= BOUND


ATTENTION_CASES = {
    # q_chunk 8 on S = 21: two chunks and a remainder of 5; GQA 4 / 2
    "causal": dict(causal=True),
    "window_softcap": dict(causal=True, window=5, softcap=50.0),
    "q_offset": dict(causal=True, window=5, q_offset=4),
    "bidirectional_scale": dict(causal=False, scale=0.3),
}


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_attention(case):
    kw = ATTENTION_CASES[case]
    t = 21 + kw.get("q_offset", 0)
    qj, qt = both(randn(3, (2, 21, 4, 16)))
    kj, kt = both(randn(4, (2, t, 2, 16)))
    vj, vt = both(randn(5, (2, t, 2, 16)))
    got = common.attention(qt, kt, vt, q_chunk=8, **kw)
    want = ref_common.attention(qj, kj, vj, q_chunk=8, **kw)
    assert got.dtype == torch.bfloat16
    assert rel_l2(got, want) <= BOUND
    # the chunking does not change a row: one chunk gives the same
    whole = common.attention(qt, kt, vt, q_chunk=1024, **kw)
    assert rel_l2(got, whole) <= BOUND


@pytest.mark.parametrize("window,softcap", [(None, None), (5, None),
                                            (5, 50.0)])
def test_decode_attention(window, softcap):
    qj, qt = both(randn(6, (2, 1, 4, 16)))
    kj, kt = both(randn(7, (2, 24, 2, 16)))
    vj, vt = both(randn(8, (2, 24, 2, 16)))
    got = common.decode_attention(qt, kt, vt, torch.tensor(13),
                                  window=window, softcap=softcap)
    want = ref_common.decode_attention(qj, kj, vj, jnp.int32(13),
                                       window=window, softcap=softcap)
    assert got.dtype == torch.bfloat16
    assert rel_l2(got, want) <= BOUND


@pytest.mark.parametrize("arch,gated", [("granite_8b", True),
                                        ("gemma2_27b", True),
                                        ("gemma2_27b", False)])
def test_ffn_apply(arch, gated):
    """silu gated (granite), gelu gated (gemma2), gelu ungated."""
    cfg = get_smoke(arch).replace(gated_ffn=gated)
    ref_cfg = ref_get_smoke(arch).replace(gated_ffn=gated)
    specs = tfm.ffn_specs(cfg)
    pj, pt = {}, {}
    for i, (name, s) in enumerate(sorted(specs.items())):
        pj[name], pt[name] = both(randn(10 + i, s.shape, s.std))
    xj, xt = both(randn(9, (2, 12, cfg.d_model), 2.0))
    got = tfm.ffn_apply(cfg, pt, xt)
    assert got.dtype == torch.bfloat16
    assert rel_l2(got, ref_tfm.ffn_apply(ref_cfg, pj, xj)) <= BOUND


# ---------------------------------------------------------------------------
# The five in-slice smoke models against the reference.
# ---------------------------------------------------------------------------
B, S, MAX_LEN = 2, 12, 24
STEPS = 4  # greedy decode steps
# the hybrid's ring cache is held at S >= its window (32 in the smoke
# model): below it the reference's ring is S slots long (R10, below)
PROMPT = {"hymba_15b": (40, 48)}  # arch -> (S, max_len)
# cache entries with no zero-padded token axis: the hybrid's SSM state,
# RWKV's state and whisper's cross-attention k/v (encoder_seq long)
NO_PADDING = ("conv", "ssm", "shift1", "shift2", "wkv", "ck", "cv")


def _batch(cfg, s: int = S):
    """``tests/test_archs.py``'s batch: seeded tokens and labels, the VLM's
    patch embeddings at 0.01 and whisper's frames N(0, 1)."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    ref = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    port = {"tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels)}
    if cfg.family == "vlm":
        ref["patch_embeds"], port["patch_embeds"] = both(
            np.full((B, cfg.vision_prefix, cfg.d_model), 0.01, np.float32))
    if cfg.family == "audio":
        ref["frames"], port["frames"] = both(
            rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)))
    return ref, port


def leaves(tree, prefix=()):
    """``(path, leaf)`` of a cache, nested by group or flat."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def clone(tree):
    return {k: clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def per_layer_params(specs, key):
    """The reference's parameter tree with every stacked leaf drawn one
    layer at a time from that layer's own spec (R7)."""
    def draw(spec, k, stacked):
        if isinstance(spec, ref_common.ParamSpec):
            if not stacked:
                return spec.initializer(k)
            one = ref_common.ParamSpec(spec.shape[1:], spec.names[1:],
                                       dtype=spec.dtype, init=spec.init,
                                       scale=spec.scale)
            return jnp.stack([one.initializer(kk) for kk in
                              jax.random.split(k, spec.shape[0])])
        keys = jax.random.split(k, len(spec))
        return {name: draw(s, kk, stacked)
                for kk, (name, s) in zip(keys, spec.items())}

    keys = jax.random.split(key, len(specs))
    return {name: draw(s, k, not isinstance(s, ref_common.ParamSpec))
            for k, (name, s) in zip(keys, specs.items())}


# the families added since R7 was found load per-layer draws
PER_LAYER_DRAW = ("rwkv6_3b", "whisper_tiny")


@functools.lru_cache(maxsize=None)
def run_both(arch: str) -> dict:
    """Prefill, ``STEPS`` greedy decode steps (the reference's tokens fed
    to both), one decode step on the reference's own prefilled cache and
    the loss of one smoke model in each package, on the reference's
    parameters (``PER_LAYER_DRAW``: each layer drawn from its own specs).
    The reference runs jitted: one compile a function."""
    ref_cfg = ref_get_smoke(arch)
    ref_model = ref_build_model(ref_cfg)
    init = per_layer_params if arch in PER_LAYER_DRAW else ref_init_params
    params = init(ref_model.param_specs(), jax.random.PRNGKey(2))
    model = build_model(get_smoke(arch), device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, params), model)
    ref_prefill = jax.jit(ref_model.prefill, static_argnums=(2,))
    ref_decode = jax.jit(ref_model.decode_step)
    prompt, max_len = PROMPT.get(arch, (S, MAX_LEN))
    rb, pb = _batch(ref_cfg, prompt)
    s = prompt + (ref_cfg.vision_prefix if ref_cfg.family == "vlm" else 0)
    out = {"s": s, "ring": ref_cfg.family == "hybrid"}
    rl, rc = ref_prefill(params, rb, max_len)
    pl, pc = model.prefill(pb, max_len)
    out["prefill"] = (pl, rl, clone(pc), rc)
    tok = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
    carried = cache_from_jax(jax.tree_util.tree_map(np.asarray, rc), "cpu")
    out["on_ref_cache"] = model.decode_step(carried, torch.from_numpy(tok),
                                            s)[0]
    steps = []
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
        rl, rc = ref_decode(params, rc, jnp.asarray(tok), jnp.int32(s + i))
        pl, pc = model.decode_step(pc, torch.from_numpy(tok), s + i)
        steps.append((pl, rl))
    out["decode"] = steps
    out["decode_cache"] = (pc, rc)
    out["loss"] = (model.loss(pb), jax.jit(ref_model.loss)(params, rb))
    out["params"] = params
    return out


def _token_axis(out, key: str) -> bool:
    """Whether ``key``'s slots past the prompt are zero padding: not the
    hybrid's (full) ring, nor a state or a cross-attention cache."""
    return key not in NO_PADDING and not (out["ring"] and key in ("k", "v"))


@pytest.mark.parametrize("arch", IN_SLICE)
def test_prefill_logits(arch):
    pl, rl, _, _ = run_both(arch)["prefill"]
    assert pl.shape == (B, get_smoke(arch).vocab_size)
    assert pl.dtype == torch.bfloat16 and bool(torch.isfinite(pl).all())
    assert rel_l2(pl, rl) <= BOUND


@pytest.mark.parametrize("arch", IN_SLICE)
def test_prefill_cache(arch):
    """Every cache tensor within the bound, in the reference's dtype; the
    slots past the prompt are exact zeros, as the reference pads them."""
    out = run_both(arch)
    _, _, pc, rc = out["prefill"]
    mine, ref = dict(leaves(pc)), dict(leaves(rc))
    assert sorted(mine) == sorted(ref)
    for path, want in ref.items():
        got = mine[path]
        assert tuple(got.shape) == want.shape
        assert dtype_name(got.dtype) == dtype_name(want.dtype)
        assert rel_l2(got, want) <= BOUND
        if _token_axis(out, path[-1]):
            assert not bool(got[:, :, out["s"]:].any())


@pytest.mark.parametrize("arch", IN_SLICE)
def test_decode_steps(arch):
    """``STEPS`` decode steps on the port's own prefilled cache; the
    written slots, the carried state and the logits within the bound."""
    out = run_both(arch)
    for pl, rl in out["decode"]:
        assert rel_l2(pl, rl) <= BOUND
    pc, rc = out["decode_cache"]
    mine = dict(leaves(pc))
    for path, want in leaves(rc):
        assert rel_l2(mine[path], want) <= BOUND
        if _token_axis(out, path[-1]):
            assert not bool(mine[path][:, :, out["s"] + STEPS:].any())


@pytest.mark.parametrize("arch", IN_SLICE)
def test_decode_step_on_the_reference_cache(arch):
    """``cache_from_jax`` carries the reference's prefilled cache over: one
    decode step on it gives the reference's logits."""
    out = run_both(arch)
    assert rel_l2(out["on_ref_cache"], out["decode"][0][1]) <= BOUND


@pytest.mark.parametrize("arch", IN_SLICE)
def test_loss(arch):
    got, want = run_both(arch)["loss"]
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(want)) <= BOUND * abs(float(want))


@pytest.mark.parametrize("arch", IN_SLICE)
def test_specs_match_the_reference(arch):
    """The param, cache and batch spec trees: shapes, logical names, init
    and scale, and dtypes by name, at full size."""
    ref_model = ref_build_model(ref_get_arch(arch))
    model = build_model(get_arch(arch), device="meta")

    def flat(tree, prefix=""):
        out = {}
        for k, s in tree.items():
            if isinstance(s, dict):
                out.update(flat(s, f"{prefix}{k}."))
            else:
                out[prefix + k] = (tuple(s.shape), tuple(s.names), s.init,
                                   s.scale, dtype_name(s.dtype))
        return out

    for mine, ref in ((model.param_specs(), ref_model.param_specs()),
                      (model.cache_specs(8, 4128),
                       ref_model.cache_specs(8, 4128)),
                      (model.batch_specs(8, 4096),
                       ref_model.batch_specs(8, 4096))):
        assert flat(mine) == flat(ref)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(math.prod(s[0]) for k, s in flat(
        ref_model.param_specs()).items())


# ---------------------------------------------------------------------------
# The loader's checks.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("edit", ["missing", "extra", "shape"])
def test_params_from_jax_refuses_a_tree_that_does_not_fit(edit):
    out = run_both("granite_8b")
    tree = jax.tree_util.tree_map(np.asarray, out["params"])
    if edit == "missing":
        del tree["group0"]["ffn"]["wg"]
    elif edit == "extra":
        tree["group0"]["attn"]["bq"] = np.zeros((2, 4, 16), np.float32)
    else:
        tree["final_norm"] = np.ones((63,), np.float32)
    model = build_model(get_smoke("granite_8b"), device="cpu")
    with pytest.raises(KeyError if edit != "shape" else ValueError):
        params_from_jax(tree, model)


def test_weights_follow_the_generator():
    """One seed gives one model; a stacked leaf is drawn layer by layer."""
    cfg = get_smoke("granite_8b")
    a = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    b = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    c = build_model(cfg, device="cpu")
    for (na, pa), (_, pb), (_, pc) in zip(a.named_parameters(),
                                          b.named_parameters(),
                                          c.named_parameters()):
        assert torch.equal(pa, pb), na
        if na.endswith(("wq", "unembed")):
            assert not torch.equal(pa, pc), na
    assert not torch.equal(a.group0[0].attn.wq, a.group0[1].attn.wq)


def test_expert_stacks_are_drawn_one_expert_at_a_time(monkeypatch):
    """R7 for expert stacks: each expert of ``wi``/``wg`` is drawn with std
    ``1/sqrt(d)`` and of ``wo`` with ``1/sqrt(moe_d_ff)``, its own fan-in
    (the reference's whole-leaf draw gives ``1/sqrt(E)``), and no draw is
    a whole ``[E, ...]`` stack (no fp32 transient of the leaf)."""
    cfg = get_smoke("llama4_scout_17b_a16e")  # d 64, moe_d_ff 128, E 4
    ne, d, f = cfg.moe_num_experts, cfg.d_model, cfg.moe_d_ff
    shapes = []
    randn = torch.randn

    def recorded(*size, **kw):
        shapes.append(tuple(size[0]) if len(size) == 1 else tuple(size))
        return randn(*size, **kw)

    monkeypatch.setattr(torch, "randn", recorded)
    model = build_model(cfg, device="cpu")
    assert shapes and not {(ne, d, f), (ne, f, d)} & set(shapes)
    for _, _, layer in model.layers():
        ffn = layer.ffn
        for name, fan_in in (("wi", d), ("wg", d), ("wo", f)):
            w = ffn[name]
            assert w.shape[0] == ne
            for e in range(ne):
                std = float(w[e].float().std())
                assert abs(std * math.sqrt(fan_in) - 1) < 0.05, (name, e,
                                                                 std)
            assert not torch.equal(w[0], w[1])


# ---------------------------------------------------------------------------
# R10: the reference's hybrid ring after a prompt shorter than the ring.
# ---------------------------------------------------------------------------
R10_S, R10_MAX_LEN = 12, 24  # S < min(max_len, window 32) = 24 ring slots


@functools.lru_cache(maxsize=None)
def r10_both() -> dict:
    """The hymba smoke model in both packages on the reference's weights:
    ``prefill(S)`` and one decode step at S (the prompt's next token fed),
    and ``prefill(S + 1)``."""
    ref_cfg = ref_get_smoke("hymba_15b")
    ref_model = ref_build_model(ref_cfg)
    params = ref_init_params(ref_model.param_specs(), jax.random.PRNGKey(2))
    model = build_model(get_smoke("hymba_15b"), device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, params), model)
    rb, pb = _batch(ref_cfg, R10_S + 1)
    rl, rc = jax.jit(ref_model.prefill, static_argnums=(2,))(
        params, {"tokens": rb["tokens"][:, :R10_S]}, R10_MAX_LEN)
    _, ref_after = jax.jit(ref_model.decode_step)(
        params, rc, rb["tokens"][:, R10_S:], jnp.int32(R10_S))
    pl, pc = model.prefill({"tokens": pb["tokens"][:, :R10_S]}, R10_MAX_LEN)
    prefilled = {k: t.clone() for k, t in pc["group0"].items()}
    step, after = model.decode_step(pc, pb["tokens"][:, R10_S:], R10_S)
    longer, _ = model.prefill({"tokens": pb["tokens"]}, R10_MAX_LEN)
    return {"ref_model": ref_model, "ref_cache": rc, "ref_after": ref_after,
            "model": model, "prefilled": prefilled, "after": after["group0"],
            "step": step, "longer": longer}


def test_r10_the_reference_ring_is_only_the_prompt_long():
    """Pinned: the reference's specs give the ring ``min(max_len, window)``
    = 24 slots, its prefill keeps 12, and its decode at position 12 then
    writes slot ``12 % 12 = 0``, over token 0."""
    r = r10_both()
    specs = r["ref_model"].cache_specs(B, R10_MAX_LEN)["group0"]
    for k in ("k", "v"):
        assert specs[k].shape == (2, B, 24, 2, 16)
        assert r["ref_cache"]["group0"][k].shape == (2, B, R10_S, 2, 16)
    before = np.asarray(r["ref_cache"]["group0"]["k"][:, :, 0])
    after = np.asarray(r["ref_after"]["group0"]["k"][:, :, 0])
    assert not np.array_equal(before, after)


def test_r10_the_ports_ring_is_zero_padded_to_its_slots():
    r = r10_both()
    model = r["model"]
    want = model.cache_specs(B, R10_MAX_LEN)["group0"]
    for k in ("k", "v"):
        got = r["prefilled"][k]
        assert tuple(got.shape) == want[k].shape == (2, B, 24, 2, 16)
        assert bool(got[:, :, :R10_S].any())
        assert not bool(got[:, :, R10_S:].any())


def test_r10_the_ports_decode_after_a_short_prompt_is_the_longer_prefill():
    """``decode_step`` at 12 after ``prefill(12)`` writes slot 12 and keeps
    token 0's slot, and gives ``prefill(13)``'s last logits within
    ``BOUND`` (measured 0.012: the decode and prefill paths' bf16 sums)."""
    r = r10_both()
    for k in ("k", "v"):
        assert torch.equal(r["after"][k][:, :, :R10_S],
                           r["prefilled"][k][:, :, :R10_S])
        assert bool(r["after"][k][:, :, R10_S].any())
    assert rel_l2(r["step"], r["longer"]) <= BOUND


def test_no_card_means_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_smoke("granite_8b"))
