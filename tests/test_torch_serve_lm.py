"""The port's LM serving driver (``repro_torch.launch.serve_lm``),
``make_serve_fns`` and the KV workload on a model's own cache, on the CPU.

``serve_lm`` runs and prints the reference's three lines (and, with
``--kv-compress``, the cache's bytes before and after); its cache
compression equals ``KVCacheCodec`` called directly.  The twin of
``tests/test_serving.py::test_decode_with_quantized_cache_logit_drift``:
granite-8b's smoke model on the reference's weights, its prefilled cache
compressed through ``KVCacheCodec(device="cpu")`` (a table per block)
and through the deprecated shim (n = e = 16): one decode step's logits
move by less than the reference's 0.15 in relative L2, and by the
reference package's own drift on the same weights and cache to within
``DRIFT_TOL`` (measured on this tree: 0.0243 against 0.0244 for the
codec, 0.0262 against 0.0267 for the shim).  The deepseek-v3 and hymba
smoke models' caches (MLA's latents, the hybrid's ring) go through the
codec with a drift under 0.15."""
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke
from repro.models import build_model as ref_build_model
from repro.models.common import init_params as ref_init_params
from repro.serving import KVCompressionConfig as RefKVConfig
from repro.serving import compress_kv_block as ref_compress
from repro.serving import decompress_kv_block as ref_decompress
from repro.serving.workloads import KVCacheCodec as RefKVCacheCodec
from repro_torch.configs import get_smoke
from repro_torch.distributed.train import make_serve_fns
from repro_torch.launch import serve_lm
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import KVCacheCodec
from repro_torch.serving import kv_compression as shim

DRIFT_TOL = 0.1  # |port drift - reference drift| <= 0.1 * reference drift
ARGS = ["--arch", "granite-8b", "--smoke", "--device", "cpu", "--batch",
        "2", "--prompt-len", "16", "--gen", "4"]


def _lines(out: str):
    return [ln for ln in out.splitlines() if ln.strip()]


@pytest.mark.parametrize("kv", [False, True], ids=["plain", "kv_compress"])
def test_serve_lm_prints_its_lines(capsys, kv):
    gen = serve_lm.main(ARGS + ["--kv-compress"] * kv)
    lines = _lines(capsys.readouterr().out)
    if kv:
        assert lines.pop(0) == "kv cache: 8192 B -> 4096 B (ratio 0.500)"
    assert lines[0].startswith("prefill: ") and "tok/s" in lines[0]
    assert lines[1].startswith("decode:  ") and "tok/s" in lines[1]
    assert lines[2] == "sample generations (first 12 token ids):"
    assert len(lines) == 5 and gen.shape == (2, 4)
    assert [eval(ln) for ln in lines[3:]] == gen.tolist()
    # one seed gives one run
    assert np.array_equal(serve_lm.main(ARGS + ["--kv-compress"] * kv), gen)


def test_serve_lm_as_a_module():
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_lm", *ARGS,
         "--arch", "internvl2-26b", "--prompt-len", "12", "--kv-compress"],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    lines = _lines(res.stdout)
    assert lines[0].startswith("kv cache: ") and len(lines) == 6


def test_serve_lm_refuses_what_it_cannot_run(monkeypatch):
    with pytest.raises(ValueError, match="multiple of 16"):
        serve_lm.main(ARGS[:-3] + ["12", "--gen", "2", "--kv-compress"])
    for flag in ("--data", "--model-par"):  # ranks come from torchrun
        with pytest.raises(ValueError, match="needs 2 ranks"):
            serve_lm.main(ARGS + [flag, "2"])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item "
                       "6c-iii"):
        serve_lm.main(["--arch", "hymba-15b", "--smoke", "--device", "cpu",
                       "--model-par", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(ARGS[:3])


def test_make_serve_fns_are_the_model_under_inference_mode():
    model = build_model(get_smoke("qwen15_4b"), device="cpu")
    prefill_fn, decode_fn = make_serve_fns(model, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (2, 16)))
    logits, cache = prefill_fn({"tokens": tokens}, 20)
    want, want_cache = model.prefill({"tokens": tokens}, 20)
    assert torch.equal(logits, want)
    tok = logits.argmax(-1, keepdim=True)
    for i in range(2):
        logits, cache = decode_fn(cache, tok, 16 + i)
        want, want_cache = model.decode_step(want_cache, tok,
                                             torch.tensor(16 + i))
        assert torch.equal(logits, want)
        tok = logits.argmax(-1, keepdim=True)
    assert cache["group0"]["k"].is_inference()
    for k in ("k", "v"):
        assert torch.equal(cache["group0"][k], want_cache["group0"][k])


def test_compress_cache_equals_the_codec_called_directly():
    model = build_model(get_smoke("granite_8b"), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 512, (2, 32)))
    _, cache = model.prefill({"tokens": tokens}, 36)
    before = {k: cache["group0"][k].clone() for k in ("k", "v")}
    raw, comp = serve_lm.compress_cache(KVCacheCodec(device="cpu"), cache,
                                        32)
    direct = KVCacheCodec(device="cpu")
    for k in ("k", "v"):
        for layer in range(before[k].shape[0]):
            block = before[k][layer, :, :32]
            direct.calibrate(block, layer=layer)
            want = direct.decompress(direct.compress(block, layer=layer),
                                     layer=layer)
            assert torch.equal(cache["group0"][k][layer, :, :32], want)
        assert torch.equal(cache["group0"][k][:, :, 32:],
                           before[k][:, :, 32:])
    assert raw == 2 * 2 * (2 * 32 * 2 * 16) * 2 and comp * 2 == raw


# ---------------------------------------------------------------------------
# The twin of the reference's logit-drift test.
# ---------------------------------------------------------------------------
B, S = 2, 32


def _drift(ref, cmp_) -> float:
    ref, cmp_ = np.asarray(ref, np.float32), np.asarray(cmp_, np.float32)
    return float(np.linalg.norm(ref - cmp_) / (np.linalg.norm(ref) + 1e-9))


def _ref_drift(method: str):
    """The reference test's computation, with the reference's shim or its
    ``KVCacheCodec`` (one table per k/v block, as ``compress_cache``)."""
    cfg = ref_get_smoke("granite_8b")
    model = ref_build_model(cfg)
    params = ref_init_params(model.param_specs(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab_size, (B, S)),
                                   jnp.int32)}
    logits, cache = model.prefill(params, batch, max_len=S + 4)
    codec = RefKVCacheCodec()
    new_cache = {}
    for g, grp in cache.items():
        ng = dict(grp)
        for key in ("k", "v"):
            kv = grp[key]
            outs = []
            for l in range(kv.shape[0]):
                block = kv[l][:, :S]
                if method == "codec":
                    codec.calibrate(block, layer=(key, l))
                    rec = codec.decompress(codec.compress(block,
                                                          layer=(key, l)),
                                           layer=(key, l))
                else:
                    lv, sc = ref_compress(block, RefKVConfig(n=16, e=16))
                    rec = ref_decompress(lv, sc, RefKVConfig(n=16, e=16),
                                         dtype=kv.dtype)
                outs.append(jnp.zeros_like(kv[l]).at[:, :S].set(rec))
            ng[key] = jnp.stack(outs)
        new_cache[g] = ng
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    lg_ref, _ = model.decode_step(params, cache, tok, jnp.int32(S))
    lg_cmp, _ = model.decode_step(params, new_cache, tok, jnp.int32(S))
    return (_drift(lg_ref.astype(jnp.float32), lg_cmp.astype(jnp.float32)),
            params)


@pytest.mark.parametrize("method", ["codec", "shim"])
def test_decode_with_quantized_cache_logit_drift(method):
    want, params = _ref_drift(method)
    model = build_model(get_smoke("granite_8b"), device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, params), model)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 512, (B, S)).astype(np.int32))
    logits, cache = model.prefill({"tokens": tokens}, S + 4)
    new_cache = {g: {k: t.clone() for k, t in c.items()}
                 for g, c in cache.items()}
    if method == "codec":
        serve_lm.compress_cache(KVCacheCodec(device="cpu"), new_cache, S)
    else:
        cfg = shim.KVCompressionConfig(n=16, e=16)  # quantization only
        for grp in new_cache.values():
            for kv in grp.values():
                for layer in range(kv.shape[0]):
                    with pytest.warns(DeprecationWarning):
                        lv, sc = shim.compress_kv_block(kv[layer, :, :S], cfg)
                        kv[layer, :, :S] = shim.decompress_kv_block(
                            lv, sc, cfg, dtype=kv.dtype)
    tok = logits.argmax(-1, keepdim=True)
    lg_ref, _ = model.decode_step(cache, tok, S)
    lg_cmp, _ = model.decode_step(new_cache, tok, S)
    got = _drift(lg_ref.float().numpy(), lg_cmp.float().numpy())
    assert got < 0.15, f"quantization-only KV cache moved logits {got}"
    assert abs(got - want) <= DRIFT_TOL * want, (got, want)


# ---------------------------------------------------------------------------
# The MLA and hybrid caches through the codec.
# ---------------------------------------------------------------------------
FAMILY_PROMPT = {"deepseek-v3-671b": 32, "hymba-15b": 48}  # hymba: S > 32


@pytest.mark.parametrize("arch", list(FAMILY_PROMPT))
def test_kv_compress_of_the_mla_and_hybrid_caches(arch, capsys):
    """``compress_cache`` walks MLA's ``ckv``/``kr`` latents (one-head
    blocks) and the hybrid's k/v ring over its ``min(S, T)`` valid slots,
    a table per block, and leaves the SSM state raw; one decode step on
    the restored cache moves the logits by less than the reference's
    0.15.  ``serve_lm --kv-compress`` runs the family end to end."""
    s = FAMILY_PROMPT[arch]
    model = build_model(get_smoke(arch), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    cfg = model.cfg
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, s)))
    logits, cache = model.prefill({"tokens": tokens}, s + 4)
    blocks = list(serve_lm.cache_blocks(cache, s))
    if cfg.mla:
        assert [n[1] for n, _ in blocks] == ["ckv"] * 1 + ["kr"] * 1 + [
            "ckv"] * 2 + ["kr"] * 2  # group0: 1 dense layer, group1: 2 MoE
        widths = (cfg.mla_kv_lora_rank, cfg.mla_qk_rope_dim)
        raw_want = cfg.num_layers * B * s * sum(widths) * 2
    else:
        t = min(s + 4, cfg.window)
        assert all(blk.shape[1] == t for _, blk in blocks)
        assert len(blocks) == 2 * cfg.num_layers
        raw_want = 2 * cfg.num_layers * B * t * cfg.num_kv_heads * (
            cfg.head_dim) * 2
    assert all(blk.dim() == 4 for _, blk in blocks)
    new = {g: {k: t.clone() for k, t in c.items()} for g, c in cache.items()}
    with torch.inference_mode():
        raw, comp = serve_lm.compress_cache(KVCacheCodec(device="cpu"), new,
                                            s)
    assert raw == raw_want and comp * 2 == raw
    for g, c in cache.items():
        for k in ("conv", "ssm"):
            if k in c:
                assert torch.equal(new[g][k], c[k])
    tok = logits.argmax(-1, keepdim=True)
    ref, _ = model.decode_step(cache, tok, s)
    got, _ = model.decode_step(new, tok, s)
    drift = _drift(ref.float().numpy(), got.float().numpy())
    assert 0 < drift < 0.15, drift
    gen = serve_lm.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt-len", str(s), "--gen",
                         "4", "--kv-compress"])
    lines = _lines(capsys.readouterr().out)
    assert lines[0].startswith("kv cache: ") and gen.shape == (2, 4)


def test_serve_lm_serves_rwkv_with_nothing_to_compress(capsys):
    """RWKV's cache is its state, with no token axis: ``--kv-compress``
    finds no block, says so, and the serve runs on."""
    gen = serve_lm.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "12", "--gen", "4",
                         "--kv-compress"])
    lines = _lines(capsys.readouterr().out)
    assert lines[0] == "kv cache: nothing compressed (no token-axis block)"
    assert lines[1].startswith("prefill: ") and gen.shape == (2, 4)
    model = build_model(get_smoke("rwkv6_3b"), device="cpu")
    _, cache = model.prefill({"tokens": torch.zeros((2, 12),
                                                    dtype=torch.long)}, 16)
    assert sorted(cache) == ["shift1", "shift2", "wkv"]
    assert list(serve_lm.cache_blocks(cache, 12)) == []
    assert serve_lm.compress_cache(KVCacheCodec(device="cpu"), cache,
                                   12) == (0, 0)


def _whisper(encoder_seq=None):
    cfg = get_smoke("whisper_tiny")
    if encoder_seq is not None:
        cfg = cfg.replace(encoder_seq=encoder_seq)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (B, 16))),
             "frames": torch.from_numpy(rng.standard_normal(
                 (B, cfg.encoder_seq, cfg.d_model))).to(torch.bfloat16)}
    logits, cache = model.prefill(batch, 20)
    return model, logits, cache


def test_kv_compress_of_the_whisper_caches(capsys):
    """Whisper's self k/v over the prompt and its cross k/v over all 64
    frames go through the codec, a table per block; one decode step on
    the restored cache moves the logits by less than the reference's
    0.15.  ``serve_lm --kv-compress`` serves the family end to end."""
    model, logits, cache = _whisper()
    cfg = model.cfg
    blocks = list(serve_lm.cache_blocks(cache, 16))
    assert [n for n, _ in blocks] == [(k, li) for k in ("k", "v", "ck", "cv")
                                      for li in range(cfg.num_layers)]
    assert [blk.shape[1] for _, blk in blocks] == [16] * 4 + [64] * 4
    new = {k: t.clone() for k, t in cache.items()}
    raw, comp = serve_lm.compress_cache(KVCacheCodec(device="cpu"), new, 16)
    per_slot = B * cfg.num_kv_heads * cfg.head_dim * 2
    assert raw == cfg.num_layers * 2 * (16 + 64) * per_slot
    assert comp * 2 == raw
    for k in ("k", "v"):
        assert torch.equal(new[k][:, :, 16:], cache[k][:, :, 16:])
    for k in ("ck", "cv"):
        assert not torch.equal(new[k], cache[k])
    tok = logits.argmax(-1, keepdim=True)
    ref, _ = model.decode_step(cache, tok, 16)
    got, _ = model.decode_step(new, tok, 16)
    drift = _drift(ref.float().numpy(), got.float().numpy())
    assert 0 < drift < 0.15, drift
    gen = serve_lm.main(["--arch", "whisper-tiny", "--smoke", "--device",
                         "cpu", "--batch", "2", "--prompt-len", "16",
                         "--gen", "4", "--kv-compress"])
    lines = _lines(capsys.readouterr().out)
    assert lines[0].startswith("kv cache: ") and gen.shape == (2, 4)


def test_a_cross_block_keeps_its_tail_raw():
    """Frames that are not a multiple of the window: the cross blocks
    compress their whole windows (64 of 70 slots) and leave the last 6
    slots as they were, bit for bit."""
    model, _, cache = _whisper(encoder_seq=70)
    new = {k: t.clone() for k, t in cache.items()}
    raw, _ = serve_lm.compress_cache(KVCacheCodec(device="cpu"), new, 16)
    cfg = model.cfg
    per_slot = B * cfg.num_kv_heads * cfg.head_dim * 2
    assert raw == cfg.num_layers * 2 * (16 + 64) * per_slot
    for k in ("ck", "cv"):
        assert torch.equal(new[k][:, :, 64:], cache[k][:, :, 64:])
        assert not torch.equal(new[k][:, :, :64], cache[k][:, :, :64])


def test_kv_cache_example_runs_on_the_cpu(tmp_path):
    """``examples/kv_cache_compression_torch.py --smoke --device cpu``
    prints its lines and writes its report section."""
    import json

    report = tmp_path / "BENCH_workloads.json"
    res = subprocess.run(
        [sys.executable, "examples/kv_cache_compression_torch.py", "--smoke",
         "--device", "cpu", "--report", str(report)],
        capture_output=True, text=True, timeout=120, check=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert res.stdout.startswith("KV cache: ")
    kv = json.loads(report.read_text())["kv_cache"]
    assert kv["device"] == "cpu" and kv["ratio"] == 0.5
    assert kv["max_rel_error"] < 0.05 and kv["top1_agreement"] > 0
