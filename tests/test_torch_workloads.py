"""The port's workloads (M8): the KV and train-state domains, the KV codec,
train-state sharding, the deprecated KV shim and the report writer, held
against the JAX package.

Inputs are made from seeds with numpy and cross as arrays; tables cross
through ``tables_from_arrays``.  ``device="cpu"`` runs every kernel
wrapper's plain version.  Levels must be equal; floats within ``max|d| <=
1e-5 * max|ref|`` against the reference's XLA arm (``use_kernels=False``)
and, for bfloat16 outputs, within one bfloat16 ulp of the reference's
value.  Calibrations follow ``tests/test_torch_codec.py``'s rule (scales
within 1e-5 relative, zones equal, histograms within 1% of their mass).
The same codec on the card: ``tests/test_torch_gpu.py``."""
import dataclasses
import json

import pytest

jnp = pytest.importorskip("jax.numpy")  # the reference; absent on the card

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core.domains import calibrate_kv as ref_calibrate_kv
from repro.core.domains import calibrate_train_state as ref_calibrate_state
from repro.core.domains import train_state_strip as ref_state_strip
from repro.serving import kv_compression as ref_shim
from repro.serving import workloads as ref_wl
from repro_torch.core import dct
from repro_torch.core.calibration import tables_from_arrays
from repro_torch.core.domains import (
    KV_DOMAIN_ID,
    TRAIN_STATE_DOMAIN_ID,
    calibrate_kv,
    calibrate_train_state,
    kv_channel_strips,
    train_state_strip,
)
from repro_torch.core.quantize import quantize
from repro_torch.kernels import ops
from repro_torch.serving import kv_compression as shim
from repro_torch.serving.workloads import (
    KVCacheCodec,
    shard_state,
    state_from_containers,
    state_to_containers,
    unshard_state,
    write_workloads_report,
)

REL_TOL = 1e-5


def carry(ref_tables):
    q = ref_tables.quant
    return tables_from_arrays(
        dataclasses.asdict(ref_tables.config), ref_tables.domain_id,
        zone=np.asarray(q.zone), scale=np.asarray(q.scale), mu=float(q.mu),
        alpha1=float(q.alpha1), lengths=np.asarray(ref_tables.book.lengths),
    )


def _walk(seed=0, b=2, t=64, h=4, d=8):
    """A smooth-ish token timeline per channel (what trained caches look
    like): a walk along the token axis, f32[B, T, H, D]."""
    rng = np.random.default_rng(seed)
    return np.cumsum(
        rng.standard_normal((b, t, h, d)).astype(np.float32), axis=1
    ) * np.float32(4.0 / t ** 0.5)


def _blocks(walk, dtype):
    """The same block for both packages: (torch tensor, jax array)."""
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    return torch.from_numpy(walk).to(dtype), jnp.asarray(walk, jdt)


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_tables_close(port, ref):
    np.testing.assert_allclose(port.quant.scale.numpy(),
                               np.asarray(ref.quant.scale), rtol=1e-5)
    np.testing.assert_array_equal(port.quant.zone.numpy(),
                                  np.asarray(ref.quant.zone))
    assert port.hist.sum() == ref.hist.sum()
    assert np.abs(port.hist - ref.hist).sum() <= 0.01 * ref.hist.sum()
    assert port.domain_id == ref.domain_id


# ---------------------------------------------------------------------------
# KV domain: calibration + the fixed-rate codec.
# ---------------------------------------------------------------------------
def test_kv_roundtrip_bf16():
    kv, _ = _blocks(_walk(), torch.bfloat16)
    codec = KVCacheCodec(device="cpu")
    tables = codec.calibrate(kv, layer="attn")
    assert tables.domain_id == KV_DOMAIN_ID
    ckv = codec.compress(kv, layer="attn")
    assert ckv.levels.dtype == torch.uint8
    assert ckv.levels.shape == (2, 4, 8, 64 // codec.config.n,
                                codec.config.e)
    out = codec.decompress(ckv, layer="attn")
    assert out.shape == kv.shape and out.dtype == kv.dtype
    assert out.is_contiguous()
    rel = float(torch.linalg.vector_norm((out - kv).float())
                / torch.linalg.vector_norm(kv.float()))
    assert rel < 0.05, rel


def test_kv_ratio_measured_from_actual_bytes():
    """The compressed/raw ratio comes from real tensor bytes — for bf16 at
    the quantization-only point (n == e) one uint8 per 2-byte sample, with
    no scale sidecar and no head_dim in it."""
    for d in (8, 128):
        kv, _ = _blocks(_walk(d=d), torch.bfloat16)
        codec = KVCacheCodec(device="cpu")
        codec.calibrate(kv)
        ckv = codec.compress(kv)
        assert ckv.raw_nbytes() == kv.numel() * 2
        assert ckv.nbytes == kv.numel()
        assert ckv.ratio == pytest.approx(0.5)


def test_kv_engine_levels_match_core_math():
    """The engine-routed fixed-rate path produces exactly the symbols of
    the core pipeline (windowed DCT + table quantize) on the channel
    strips."""
    kv, _ = _blocks(_walk(), torch.float32)
    codec = KVCacheCodec(device="cpu")
    tables = codec.calibrate(kv)
    ckv = codec.compress(kv)
    strips = torch.from_numpy(kv_channel_strips(kv, codec.config.n))
    coeffs = dct.forward_dct(dct.window_signal(strips, codec.config.n),
                             codec.config.e)
    ref = quantize(coeffs, tables.quant)
    np.testing.assert_array_equal(ckv.levels.reshape(ref.shape).numpy(),
                                  ref.numpy())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_kv_codec_matches_reference(dtype):
    """The port's levels equal the reference's XLA arm's on the same block
    with carried tables; its reconstruction is within the stated bound."""
    kv, kv_ref = _blocks(_walk(seed=3, d=16), dtype)
    ref = ref_wl.KVCacheCodec(use_kernels=False)
    ref_tab = ref.calibrate(kv_ref, layer="k")
    codec = KVCacheCodec(device="cpu")
    codec.set_tables(carry(ref_tab), layer="k", dtype=dtype)
    before = dict(ops.LAUNCHES)
    ckv = codec.compress(kv, layer="k")
    ref_ckv = ref.compress(kv_ref, layer="k")
    np.testing.assert_array_equal(ckv.levels.numpy(),
                                  np.asarray(ref_ckv.levels))
    assert ckv.nbytes == ref_ckv.nbytes and ckv.t == ref_ckv.t
    got = codec.decompress(ckv, layer="k")
    want = _np(ref.decompress(ref_ckv, layer="k"))
    assert ops.LAUNCHES == before  # the CPU runs the plain versions only
    assert got.dtype == dtype and got.shape == kv.shape
    bound = REL_TOL * np.abs(want).max()
    if dtype == torch.bfloat16:  # one bfloat16 ulp of the reference's value
        bound = np.maximum(bound, np.abs(want) * 2.0 ** -7)
    assert np.all(np.abs(got.float().numpy() - want) <= bound)


def test_calibrate_kv_matches_reference():
    walk = _walk(seed=5, t=128, d=16)
    kv, kv_ref = _blocks(walk, torch.bfloat16)
    port = calibrate_kv(kv)
    ref = ref_calibrate_kv(kv_ref)
    assert_tables_close(port, ref)
    np.testing.assert_array_equal(
        kv_channel_strips(kv, 16),
        np.moveaxis(_np(kv_ref), 1, -1).reshape(-1, 128))


def test_kv_tables_per_layer_and_dtype():
    """Tables — and therefore engine plans — are keyed per (layer group,
    dtype); an uncalibrated group fails loudly."""
    kv16, _ = _blocks(_walk(seed=1), torch.bfloat16)
    kv32, _ = _blocks(_walk(seed=2), torch.float32)
    codec = KVCacheCodec(device="cpu")
    t_a = codec.calibrate(kv16, layer="a")
    t_b = codec.calibrate(kv32, layer="a")  # same layer, other dtype
    assert codec.tables_for(layer="a", dtype=torch.bfloat16) is t_a
    assert codec.tables_for(layer="a", dtype=torch.float32) is t_b
    assert codec.tables_for(layer="a", dtype=np.float32) is t_b
    with pytest.raises(KeyError, match="no KV tables"):
        codec.compress(kv16, layer="uncalibrated")
    codec.compress(kv16, layer="a")
    codec.compress(kv32, layer="a")
    assert codec.encoder.stats.dispatches >= 2


def test_kv_shape_validation():
    codec = KVCacheCodec(device="cpu")
    kv, _ = _blocks(_walk(), torch.bfloat16)
    codec.calibrate(kv)
    with pytest.raises(ValueError, match=r"\[B, T, H, D\]"):
        codec.compress(kv[0])  # 3-D
    with pytest.raises(ValueError):
        codec.compress(kv[:, :30])  # T % n != 0
    with pytest.raises(ValueError):
        kv_channel_strips(np.zeros((2, 30, 4, 8), np.float32), 16)
    with pytest.raises(ValueError):
        calibrate_kv(np.zeros((4, 8), np.float32))


def test_no_card_means_an_error(monkeypatch):
    """The workloads' engines run on the card unless the caller asks for
    the CPU; with no card they raise rather than run on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVCacheCodec()
    arrays = {"m": np.ones((64, 64), np.float32)}
    tables = calibrate_train_state(arrays)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_to_containers(arrays, tables)
    conts, manifest = state_to_containers(arrays, tables, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_containers(conts, manifest, tables)


# ---------------------------------------------------------------------------
# Train-state domain: sharding + the batched container path.
# ---------------------------------------------------------------------------
def _smooth(rng, shape):
    t = np.cumsum(rng.standard_normal(shape), axis=0).astype(np.float32)
    return t / np.abs(t).max()


@pytest.mark.parametrize("normalize", [False, True])
def test_shard_state_matches_reference(normalize):
    """Shards and manifests bit-exact against the reference's, torch
    leaves included; the round trip is exact without normalization."""
    rng = np.random.default_rng(0)
    arrays = {
        "w": rng.standard_normal((33, 17)).astype(np.float32),
        "b": rng.standard_normal(5).astype(np.float16),
        "z": np.zeros((3, 3), np.float32),
    }
    ref_shards, ref_manifest = ref_wl.shard_state(
        arrays, shard_len=128, normalize=normalize)
    as_torch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    for src in (arrays, as_torch):
        shards, manifest = shard_state(src, shard_len=128,
                                       normalize=normalize)
        assert manifest == ref_manifest
        assert len(shards) == len(ref_shards)
        for a, b in zip(shards, ref_shards):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    back = unshard_state(shards, manifest)
    ref_back = ref_wl.unshard_state(ref_shards, ref_manifest)
    for k in arrays:
        assert back[k].dtype == ref_back[k].dtype
        assert back[k].tobytes() == ref_back[k].tobytes()
    if not normalize:
        np.testing.assert_array_equal(back["w"], arrays["w"])
        assert back["b"].dtype == np.float16
    with pytest.raises(ValueError):
        unshard_state(shards[:-1], manifest)
    with pytest.raises(ValueError, match="positive"):
        shard_state(arrays, shard_len=0)


def test_bf16_leaf_shards_and_returns_as_a_tensor():
    t = torch.linspace(-2, 2, 300).to(torch.bfloat16).reshape(3, 100)
    shards, manifest = shard_state({"h": t}, shard_len=128)
    assert manifest[0]["dtype"] == "bfloat16"
    back = unshard_state(shards, manifest)["h"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


def test_train_state_containers_roundtrip():
    rng = np.random.default_rng(1)
    arrays = {"m": _smooth(rng, (64, 64))}
    tables = calibrate_train_state(arrays)
    assert tables.domain_id == TRAIN_STATE_DOMAIN_ID
    conts, manifest = state_to_containers(arrays, tables, shard_len=1024,
                                          device="cpu")
    assert len(conts) == 4
    assert all(c.domain_id == TRAIN_STATE_DOMAIN_ID for c in conts)
    rec = state_from_containers(conts, manifest, tables, device="cpu")
    rel = np.linalg.norm(rec["m"] - arrays["m"]) / np.linalg.norm(
        arrays["m"])
    assert rel < 0.02, rel
    blob = sum(len(c.to_bytes()) for c in conts)
    assert blob < arrays["m"].nbytes * 0.8  # actually compressed


def test_engine_calls_cover_the_shards_in_runs_under_the_budget():
    from repro_torch.serving.workloads import MAX_CALL_SAMPLES, engine_calls

    assert engine_calls([]) == []
    assert engine_calls([5] * 4, budget=10) == [slice(0, 2), slice(2, 4)]
    assert engine_calls([5, 5, 3, 12, 1], budget=10) == [
        slice(0, 2), slice(2, 3), slice(3, 4), slice(4, 5)]
    full = 1 << 16  # a 2-layer granite-8b state's m and v: 25600 shards
    calls = engine_calls([full] * 25600)
    assert [c.stop - c.start for c in calls] == [16384, 9216]
    assert MAX_CALL_SAMPLES == 1 << 30


def test_state_in_several_engine_calls_is_the_one_call_state(monkeypatch):
    """A state split over several engine calls gives the one-call
    containers byte for byte, and decodes in several calls to the same
    leaves."""
    from repro_torch.serving import workloads as wl

    rng = np.random.default_rng(2)
    arrays = {"m": _smooth(rng, (64, 64)), "v": _smooth(rng, (48, 32))}
    tables = calibrate_train_state(arrays)
    one, manifest = state_to_containers(arrays, tables, shard_len=1024,
                                        device="cpu")
    whole = state_from_containers(one, manifest, tables, device="cpu")
    monkeypatch.setattr(wl, "MAX_CALL_SAMPLES", 2048)
    assert len(wl.engine_calls([c.signal_length for c in one])) == 3
    split, manifest2 = state_to_containers(arrays, tables, shard_len=1024,
                                           device="cpu")
    assert manifest2 == manifest
    assert [c.to_bytes() for c in split] == [c.to_bytes() for c in one]
    back = state_from_containers(split, manifest, tables, device="cpu")
    for k in arrays:
        assert np.array_equal(back[k], whole[k])


def test_train_state_strip_and_calibration_match_reference():
    """The strip is the reference's bit for bit (the subsampled runs
    included, torch leaves on the way); the tables follow the
    calibration rule."""
    rng = np.random.default_rng(2)
    tree = {
        "p": {"w": rng.standard_normal((96, 64)).astype(np.float32) * 0.02,
              "b": rng.standard_normal(64).astype(np.float16)},
        "m": [_smooth(rng, (128, 64)) * 1e-3, np.arange(7, dtype=np.int32)],
        "v": _smooth(rng, (64, 64)).astype(np.float64) * 1e-6,
    }
    as_torch = {"p": {k: torch.from_numpy(v) for k, v in tree["p"].items()},
                "m": [torch.from_numpy(x) for x in tree["m"]],
                "v": torch.from_numpy(tree["v"])}
    for max_elems in (1 << 22, 5000):
        want = ref_state_strip(tree, max_elems=max_elems, seed=4)
        for src in (tree, as_torch):
            got = train_state_strip(src, max_elems=max_elems, seed=4)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert_tables_close(calibrate_train_state(as_torch),
                        ref_calibrate_state(tree))


@pytest.mark.parametrize("tree", [
    {"steps": np.arange(10, dtype=np.int32)},
    {"a": np.zeros((0,), np.float32), "b": np.zeros((0, 4), np.float16)},
], ids=["int-only", "all-empty"])
def test_calibrate_train_state_needs_float_leaves(tree):
    """R3: with no float leaf that holds data, calibration raises — as the
    reference does (``core/domains.py:135``)."""
    with pytest.raises(ValueError, match="float"):
        ref_calibrate_state(tree)
    with pytest.raises(ValueError, match="float"):
        calibrate_train_state(tree)


# ---------------------------------------------------------------------------
# The deprecated KV shim (twins of tests/test_serving.py and the shim pin).
# ---------------------------------------------------------------------------
def _shim_pair(cfg, kv, kv_ref):
    with pytest.warns(DeprecationWarning, match="KVCacheCodec"):
        levels, scale = shim.compress_kv_block(kv, cfg)
    ref_levels, ref_scale = ref_shim.compress_kv_block(kv_ref, cfg)
    return levels, scale, np.asarray(ref_levels), np.asarray(ref_scale)


@pytest.mark.parametrize("n,e", [(8, 4), (16, 8), (16, 16)])
def test_shim_roundtrip_error(n, e):
    """Levels within one of the reference's (the DCT product sums in
    another order) in at most 1% of the cells, scales within 1e-5; the
    reference's error bounds."""
    rng = np.random.default_rng(0)
    base = np.cumsum(rng.standard_normal((2, 64, 4, 32)) * 0.2, axis=1)
    kv, kv_ref = _blocks(base.astype(np.float32), torch.bfloat16)
    cfg = shim.KVCompressionConfig(n=n, e=e)
    levels, scale, ref_levels, ref_scale = _shim_pair(
        cfg, kv, kv_ref)
    d = np.abs(levels.numpy().astype(int) - ref_levels.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01
    np.testing.assert_allclose(scale.numpy(), ref_scale, rtol=1e-5)
    with pytest.warns(DeprecationWarning):
        rec = shim.decompress_kv_block(levels, scale, cfg)
    assert rec.dtype == torch.bfloat16 and rec.shape == kv.shape
    rel = float(torch.linalg.vector_norm((rec - kv).float())
                / torch.linalg.vector_norm(kv.float()))
    assert rel < (0.02 if e == n else 0.25)


def test_shim_compression_saves_memory():
    cfg = shim.KVCompressionConfig(n=16, e=8)
    kv = torch.zeros((1, 64, 4, 32), dtype=torch.bfloat16)
    with pytest.warns(DeprecationWarning):
        levels, scale = shim.compress_kv_block(kv, cfg)
    comp = levels.numel() + scale.numel() * 4
    assert comp < kv.numel() * 2 * 0.7


def test_shim_ratio_and_mapping():
    cfg = shim.KVCompressionConfig(n=16, e=8)
    assert cfg.ratio == pytest.approx(8 / 32 + 4 / 32)
    assert cfg.ratio == ref_shim.KVCompressionConfig(n=16, e=8).ratio
    kv, kv_ref = _blocks(_walk(), torch.float32)
    levels, scale, ref_levels, _ = _shim_pair(cfg, kv, kv_ref)
    assert levels.shape == ref_levels.shape == (2, 4, 4, 8, 8)
    assert scale.shape == (2, 4, 4, 8)
    assert int(levels.min()) >= 1
    norm = (levels.numpy().astype(np.float32) - 128.0) / 127.0
    assert np.all(np.abs(norm) <= 1.0)
    with pytest.warns(DeprecationWarning):
        rec = shim.decompress_kv_block(levels, scale, cfg,
                                       dtype=torch.float32)
    ref_rec = np.asarray(ref_shim.decompress_kv_block(
        jnp.asarray(levels.numpy()), jnp.asarray(scale.numpy()), cfg,
        dtype=jnp.float32))
    assert rec.shape == kv.shape
    assert np.abs(rec.numpy() - ref_rec).max() <= REL_TOL * np.abs(
        ref_rec).max()


# ---------------------------------------------------------------------------
# Report writer.
# ---------------------------------------------------------------------------
def test_write_workloads_report_merges_sections(tmp_path):
    path = str(tmp_path / "BENCH_workloads.json")
    ref_path = str(tmp_path / "ref" / "BENCH_workloads.json")
    for p, write in ((path, write_workloads_report),
                     (ref_path, ref_wl.write_workloads_report)):
        write("kv_cache", {"ratio": 0.5}, p)
        write("checkpoint", {"ratio": 0.3}, p)
        write("kv_cache", {"ratio": 0.25}, p)  # overwrite
    with open(path) as f:
        report = json.load(f)
    assert report == {
        "kv_cache": {"ratio": 0.25}, "checkpoint": {"ratio": 0.3}
    }
    assert open(path).read() == open(ref_path).read()


def test_train_state_scales_cover_the_whole_state():
    """Past ``max_elems`` the strip samples a run of each leaf.  The
    reference takes the 100th-percentile scales over that sample, so a
    drifting accumulator whose extremes fall outside its run clips (its
    reconstruction off by far more than the 0.02 bound); the port's scales
    cover every window of the state, and the same leaf stays within it."""
    from repro_torch.core.quantize import dequantize

    rng = np.random.default_rng(11)  # a walk whose sampled run stays low
    walk = np.cumsum(rng.standard_normal(1 << 20)).astype(np.float32)
    tree = {"p": rng.standard_normal(1 << 25).astype(np.float32) * 0.02,
            "m": walk * np.float32(1e-3 / np.abs(walk).max())}
    port = calibrate_train_state(tree)
    ref = carry(ref_calibrate_state(tree))
    n, e = port.config.n, port.config.e
    flat = torch.from_numpy(tree["m"] / np.abs(tree["m"]).max())
    coeffs = dct.forward_dct(dct.window_signal(flat, n), e)
    assert np.all(port.quant.scale.numpy() >= 1.05 * coeffs.abs().amax(0)
                  .numpy() * (1 - 1e-6))

    def rel(tables):
        rec = dequantize(quantize(coeffs, tables.quant), tables.quant)
        out = dct.inverse_dct(rec, n).reshape(-1)
        return float(torch.linalg.vector_norm(out - flat)
                     / torch.linalg.vector_norm(flat))

    assert rel(port) < 0.02
    assert rel(ref) > 0.02  # the reference's sample missed the extremes
