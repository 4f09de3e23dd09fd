"""The port's encoder-decoder layers (``repro_torch.models.encdec``, the
whisper backbone) held against the JAX package on the CPU.

Inputs and weights are made from numpy seeds and cross bit for bit (bf16
through its pattern): matrices at their spec's std, the q/k/v biases
N(0, 0.1), the norms' weights 1 + N(0, 0.1).  The reference's functions
run jitted, as its model runs them (inside ``lax.scan``).  XLA then keeps
a residual sum in fp32 inside the next norm's statistics, and the port
rounds as that compiled program does (``encdec._add_norm``).  Every output
is held in relative L2 to ``BOUND = 2**-6`` (2 bf16 ulps).  Measured on
this tree (CPU, torch 2.13, JAX 0.9): the encoder layer 0 (7.7e-4 with
the plain norm of the rounded sum); the decoder's train path 5.0e-3, its
self k 2.9e-3 and v, ck, cv 0; one decode step on the reference's caches
5.7e-3, its written k 8.1e-4 and v 0; S = 12 decode steps after a prefill
of none and of 5 tokens against the reference's train path 5.0e-3.  Each
decoder-layer reading is the layer compiled alone: there XLA also ropes
the biased q and k in fp32 before rounding them, where the model's
compiled scan rounds them first (the smoke model's prefill, cache and
decode steps read 0 to 2.3e-4 in ``test_torch_models.py``), so the port
keeps the model's rounding.
"""
import pytest

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke
from repro.models import encdec as ref_encdec
from repro.models.common import rope as ref_rope
from repro_torch.configs import get_smoke
from repro_torch.models import encdec
from repro_torch.models.common import rms_norm
from test_torch_models import BOUND, both, dtype_name, randn, rel_l2

ARCH = "whisper_tiny"  # smoke: d 32, 2 heads of 16, d_ff 64, 64 frames
B, S = 2, 12


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _params(specs, seed: int):
    """One layer's weights in both packages."""
    pj, pt = {}, {}
    for i, (name, spec) in enumerate(sorted(_flat(specs).items())):
        if spec.init == "normal":
            arr = randn(seed + i, spec.shape, spec.std)
        else:
            arr = randn(seed + i, spec.shape, 0.1) + (spec.init == "ones")
        a, t = both(arr)
        for tree, leaf in ((pj, a), (pt, t)):
            *path, last = name.split(".")
            for k in path:
                tree = tree.setdefault(k, {})
            tree[last] = leaf
    return pj, pt


def _cfgs():
    return get_smoke(ARCH), ref_get_smoke(ARCH)


def _enc_out(cfg):
    """An encoder output in both packages: normed frames."""
    return both(randn(1, (B, cfg.encoder_seq, cfg.d_model)))


def _rope_tables(cfg, positions):
    sj, cj = ref_rope(jnp.asarray(positions), cfg.head_dim, cfg.rope_theta)
    return (sj, cj), (to_t(sj), to_t(cj))


def to_t(a):
    return both(np.asarray(a), a.dtype)[1]


@pytest.mark.parametrize("which", ["encoder", "decoder"])
def test_specs_match_the_reference(which):
    cfg, ref_cfg = _cfgs()
    mine = _flat(getattr(encdec, f"{which}_layer_specs")(cfg))
    ref = _flat(getattr(ref_encdec, f"{which}_layer_specs")(ref_cfg))
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert (mine[k].shape, mine[k].names, mine[k].init, mine[k].scale,
                dtype_name(mine[k].dtype)) == (
            ref[k].shape, ref[k].names, ref[k].init, ref[k].scale,
            dtype_name(ref[k].dtype)), k


def test_add_norm_is_the_compiled_references():
    """The residual add and the norm after it, against the reference's
    ``x + y`` then ``rms_norm`` compiled in one program."""
    from repro.models.common import rms_norm as ref_rms_norm

    xj, xt = both(randn(2, (B, 40, 32), 2.0))
    yj, yt = both(randn(3, (B, 40, 32), 2.0))
    wj, wt = both(1.0 + randn(4, (32,), 0.1))
    s, h = encdec._add_norm(xt, yt, wt)
    want = jax.jit(lambda x, y, w: ref_rms_norm(x + y, w))(xj, yj, wj)
    assert torch.equal(s, xt + yt)
    assert rel_l2(h, want) == 0.0
    assert rel_l2(rms_norm(s, wt), want) > 0  # the rounded sum's norm


def test_encoder_layer_apply():
    """The bidirectional layer over the frames: 64 frames in one query
    chunk."""
    cfg, ref_cfg = _cfgs()
    pj, pt = _params(encdec.encoder_layer_specs(cfg), 10)
    xj, xt = both(randn(5, (B, cfg.encoder_seq, cfg.d_model)))
    got = encdec.encoder_layer_apply(cfg, pt, xt)
    want = jax.jit(lambda p, x: ref_encdec.encoder_layer_apply(
        ref_cfg, p, x))(pj, xj)
    assert got.dtype == torch.bfloat16
    assert rel_l2(got, want) <= BOUND


def _train_both(cfg, ref_cfg, pj, pt, s: int, seed: int = 6):
    xj, xt = both(randn(seed, (B, s, cfg.d_model)))
    ej, et = _enc_out(cfg)
    (sj, cj), (st, ct) = _rope_tables(cfg, np.arange(s))
    want = jax.jit(lambda p, x, e, a, b: ref_encdec.decoder_layer_train(
        ref_cfg, p, x, e, a, b))(pj, xj, ej, sj, cj)
    got = encdec.decoder_layer_train(cfg, pt, xt, et, st, ct)
    return got, want, (xj, xt)


def test_decoder_layer_train():
    """The output, the self-attention's k/v over S and the
    cross-attention's k/v over the frames."""
    cfg, ref_cfg = _cfgs()
    pj, pt = _params(encdec.decoder_layer_specs(cfg), 30)
    (x, kv, ckv), (xw, kvw, ckvw), _ = _train_both(cfg, ref_cfg, pj, pt, S)
    assert rel_l2(x, xw) <= BOUND
    for g, w in zip(kv + ckv, kvw + ckvw):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        assert rel_l2(g, w) <= BOUND
    assert kv[0].shape == (B, S, cfg.num_kv_heads, cfg.head_dim)
    assert ckv[0].shape == (B, cfg.encoder_seq, cfg.num_kv_heads,
                            cfg.head_dim)


def _cache(kv, ckv, t: int):
    """A layer's decode cache of ``t`` self slots holding ``kv``."""
    k, v = kv
    out = {}
    for key, src in (("k", k), ("v", v)):
        z = torch.zeros((B, t) + tuple(src.shape[2:]), dtype=src.dtype)
        z[:, :src.shape[1]] = src
        out[key] = z
    out["ck"], out["cv"] = ckv
    return out


def test_decoder_layer_decode():
    """One step at position S on the reference's own caches (its self k/v
    padded to 16 slots): the output and the written slot."""
    cfg, ref_cfg = _cfgs()
    pj, pt = _params(encdec.decoder_layer_specs(cfg), 30)
    _, (_, kvw, ckvw), _ = _train_both(cfg, ref_cfg, pj, pt, S)
    t = S + 4
    ref_cache = {k: jnp.asarray(np.asarray(c.float().numpy()), jnp.bfloat16)
                 for k, c in _cache(tuple(map(to_t, kvw)),
                                    tuple(map(to_t, ckvw)), t).items()}
    port_cache = {k: to_t(v) for k, v in ref_cache.items()}
    x1j, x1t = both(randn(7, (B, 1, cfg.d_model)))
    (sj, cj), (st, ct) = _rope_tables(cfg, np.full((B, 1), S))
    want, want_cache = jax.jit(
        lambda p, x, c, a, b: ref_encdec.decoder_layer_decode(
            ref_cfg, p, x, c, a, b, jnp.int32(S)))(pj, x1j, ref_cache, sj,
                                                   cj)
    got, got_cache = encdec.decoder_layer_decode(cfg, pt, x1t, port_cache,
                                                 st, ct, torch.tensor(S))
    assert rel_l2(got, want) <= BOUND
    for k in ("k", "v"):
        assert rel_l2(got_cache[k], want_cache[k]) <= BOUND
        assert bool(got_cache[k][:, S].any())
        assert not bool(got_cache[k][:, S + 1:].any())


@pytest.mark.parametrize("split", [0, 5])
def test_prefill_then_decode_steps_is_the_train_path(split):
    """``decoder_layer_train`` on the first ``split`` tokens (none: an
    empty cache), then one ``decoder_layer_decode`` a token: the outputs
    are the reference's train path's over all S."""
    cfg, ref_cfg = _cfgs()
    pj, pt = _params(encdec.decoder_layer_specs(cfg), 30)
    _, (want, _, _), (_, xt) = _train_both(cfg, ref_cfg, pj, pt, S)
    _, et = _enc_out(cfg)
    if split:
        _, (st, ct) = _rope_tables(cfg, np.arange(split))
        first, kv, ckv = encdec.decoder_layer_train(cfg, pt, xt[:, :split],
                                                    et, st, ct)
        outs = [first]
    else:
        ckv = encdec._proj_qkv(cfg, pt["cross"], et, et)[1:]
        kv = (torch.zeros((B, 0, cfg.num_kv_heads, cfg.head_dim),
                          dtype=torch.bfloat16),) * 2
        outs = []
    cache = _cache(kv, ckv, S)
    for i in range(split, S):
        _, (st, ct) = _rope_tables(cfg, np.full((B, 1), i))
        y, cache = encdec.decoder_layer_decode(cfg, pt, xt[:, i:i + 1],
                                               cache, st, ct,
                                               torch.tensor(i))
        outs.append(y)
    assert rel_l2(torch.cat(outs, 1), want) <= BOUND
