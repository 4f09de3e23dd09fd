"""The port's checkpoints (M8): atomicity, CRCs, the compressed v2 state
blob, the v1 restore, and the interchange with the JAX package — a
checkpoint written by either package restores in the other.

Trees are made from seeds with numpy.  Leaf keys (JAX's ``keystr``) and
file names must equal the reference's, raw leaves (a bfloat16 leaf
included) must restore bit for bit in both directions, and compressed
leaves within relative rms 0.02 of the original (the reference's bound).
Each package calibrates its own tables, so the two encodes of one tree
compare by their level grids: equal, or one level apart in at most 1e-4
of the cells (the tables' scales agree to float32 noise and the DCTs sum
in different orders, so a coefficient on a cell boundary may land on
either side).  A blob the port decodes is within ``1e-5 * max|ref|`` of
the reference's decode of the same blob.  ``device="cpu"`` runs the plain
versions; on the card: ``tests/test_torch_gpu.py``.  The resumes (M10b)
run the port's train step on the CPU from a checkpoint of the train state
in the reference's layout: bit for bit an uninterrupted run when the
checkpoint is raw, within stated bounds when it is compressed or written
by the JAX package."""
import json
import os
import zlib

import pytest

jnp = pytest.importorskip("jax.numpy")  # the reference; absent on the card

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import encode as ref_encode
from repro.core.calibration import calibrate as ref_calibrate
from repro.distributed import checkpoint as ref_ckpt
from repro_torch.core import calibrate, encode, symlen
from repro_torch.core.calibration import tables_from_hist
from repro_torch.core.container import Container
from repro_torch.distributed import checkpoint as ckpt

REL_RMS = 0.02
FLIP_SHARE = 1e-4


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": rng.standard_normal((128, 64)).astype(np.float32),
            "b": rng.standard_normal((64,)).astype(np.float32),
        },
        "m": {"w": rng.standard_normal((128, 64)).astype(np.float32) * 0.01},
        "step_tokens": np.arange(10, dtype=np.int32),
    }


def _smooth(rng, shape):
    t = np.cumsum(rng.standard_normal(shape), axis=0).astype(np.float32)
    return t / np.abs(t).max()


def _rel(a, b) -> float:
    a = np.asarray(a, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Twins of tests/test_checkpoint.py.
# ---------------------------------------------------------------------------
def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save_checkpoint(str(tmp_path), 7, tree)
    assert ckpt.latest_step(str(tmp_path)) == 7
    step, restored = ckpt.restore_latest(str(tmp_path), tree)
    assert step == 7
    for k in ("w", "b"):
        np.testing.assert_array_equal(restored["params"][k],
                                      tree["params"][k])
    np.testing.assert_array_equal(restored["m"]["w"], tree["m"]["w"])
    np.testing.assert_array_equal(restored["step_tokens"],
                                  tree["step_tokens"])


def test_latest_wins(tmp_path):
    tree = _tree()
    ckpt.save_checkpoint(str(tmp_path), 5, tree)
    tree2 = _tree(1)
    ckpt.save_checkpoint(str(tmp_path), 12, tree2)
    step, restored = ckpt.restore_latest(str(tmp_path), tree)
    assert step == 12
    np.testing.assert_array_equal(restored["params"]["w"],
                                  tree2["params"]["w"])
    assert ckpt.restore_latest(str(tmp_path / "none"), tree) is None


def test_torn_write_invisible(tmp_path):
    """A temp dir from a crashed writer is never picked up."""
    tree = _tree()
    ckpt.save_checkpoint(str(tmp_path), 3, tree)
    os.makedirs(tmp_path / ".tmp_ckpt_dead", exist_ok=True)
    os.makedirs(tmp_path / "step_000000000099")  # no manifest -> incomplete
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_crc_detects_corruption(tmp_path):
    tree = _tree()
    path = ckpt.save_checkpoint(str(tmp_path), 1, tree)
    victim = next(iter(_manifest(path)["leaves"].values()))["file"] + ".npy"
    fp = os.path.join(path, victim)
    raw = bytearray(open(fp, "rb").read())
    raw[-1] ^= 0xFF
    open(fp, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        ckpt.restore_checkpoint(str(tmp_path), 1, tree)


def test_fptc_compressed_checkpoint(tmp_path):
    """Compressed float leaves restore within near-lossless tolerance and
    actually shrink on disk."""
    rng = np.random.default_rng(3)
    t = np.cumsum(rng.standard_normal((256, 64)), axis=0).astype(np.float32)
    t /= np.abs(t).max()
    tree = {"m": t}
    path = ckpt.save_checkpoint(str(tmp_path), 2, tree, compress=True,
                                device="cpu")
    files = os.listdir(path)
    assert any(f.endswith(".fptc") for f in files)
    _, restored = ckpt.restore_latest(str(tmp_path), tree, device="cpu")
    assert _rel(restored["m"], t) < REL_RMS
    blob = os.path.getsize(
        os.path.join(path, [f for f in files if f.endswith(".fptc")][0]))
    assert blob < t.nbytes * 0.8


# ---------------------------------------------------------------------------
# Twins of tests/test_workloads.py's checkpoint tests.
# ---------------------------------------------------------------------------
def _v2_tree(rng):
    return {
        "p": {"w": _smooth(rng, (256, 64)), "b": _smooth(rng, (64,))},
        "m": {"w": _smooth(rng, (256, 64)) * 0.01},
        "step_tokens": np.arange(10, dtype=np.int32),
    }


def test_checkpoint_v2_roundtrip(tmp_path):
    tree = _v2_tree(np.random.default_rng(3))
    as_torch = {"p": {k: torch.from_numpy(v) for k, v in tree["p"].items()},
                "m": {"w": torch.from_numpy(tree["m"]["w"])},
                "step_tokens": torch.from_numpy(tree["step_tokens"])}
    path = ckpt.save_checkpoint(str(tmp_path), 2, as_torch, compress=True,
                                device="cpu")
    manifest = _manifest(path)
    assert manifest["version"] == 2
    assert os.path.exists(os.path.join(path, "state.fptc"))
    assert manifest["leaves"]["['p']['w']"]["codec"] == "fptc_state"
    assert manifest["leaves"]["['m']['w']"]["codec"] == "fptc_state"
    assert "codec" not in manifest["leaves"]["['p']['b']"]  # < min size
    assert "codec" not in manifest["leaves"]["['step_tokens']"]

    for like in (tree, as_torch):  # leaves land where tree_like's live
        _, restored = ckpt.restore_latest(str(tmp_path), like, device="cpu")
        assert isinstance(restored["p"]["w"], type(like["p"]["w"]))
        np.testing.assert_array_equal(np.asarray(restored["step_tokens"]),
                                      tree["step_tokens"])
        np.testing.assert_array_equal(np.asarray(restored["p"]["b"]),
                                      tree["p"]["b"])
        for a, b in (("p", "w"), ("m", "w")):
            assert _rel(restored[a][b], tree[a][b]) < REL_RMS, (a, b)
    blob = os.path.getsize(os.path.join(path, "state.fptc"))
    assert blob < (tree["p"]["w"].nbytes + tree["m"]["w"].nbytes) * 0.8


def test_raw_keys_are_written_raw(tmp_path):
    """``raw=("p",)`` (a training state's weights: ``save_train_state``):
    the fp32 leaves under ``p`` are written raw and come back bit for bit,
    ``m`` compresses as before, and the reference restores both."""
    tree = _v2_tree(np.random.default_rng(6))
    path = ckpt.save_checkpoint(str(tmp_path), 2, tree, compress=True,
                                device="cpu", raw=("p",))
    leaves = _manifest(path)["leaves"]
    assert "codec" not in leaves["['p']['w']"]
    assert leaves["['m']['w']"]["codec"] == "fptc_state"
    for got in (ckpt.restore_latest(str(tmp_path), tree, device="cpu")[1],
                ref_ckpt.restore_latest(str(tmp_path), tree)[1]):
        np.testing.assert_array_equal(np.asarray(got["p"]["w"]),
                                      tree["p"]["w"])
        assert _rel(got["m"]["w"], tree["m"]["w"]) < REL_RMS


def test_checkpoint_v2_crc_detects_state_corruption(tmp_path):
    tree = {"m": _smooth(np.random.default_rng(4), (256, 64))}
    path = ckpt.save_checkpoint(str(tmp_path), 1, tree, compress=True,
                                device="cpu")
    fp = os.path.join(path, "state.fptc")
    raw = bytearray(open(fp, "rb").read())
    raw[-1] ^= 0xFF
    open(fp, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        ckpt.restore_checkpoint(str(tmp_path), 1, tree, device="cpu")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_v1_manifest_still_restores(tmp_path, writer):
    """A pre-v2 checkpoint (per-leaf .fptc containers with inline aux
    tables), written with either package's codec, restores in the port."""
    arr = _smooth(np.random.default_rng(5), (256, 64))
    tree = {"m": arr}
    key = "['m']"
    name = ckpt._fname(key)
    final = tmp_path / "step_000000000007"
    os.makedirs(final)
    flat = arr.astype(np.float32).ravel()
    if writer == "port":
        tables = calibrate(flat, ckpt.CKPT_CODEC_CONFIG, max_windows=4096)
        blob = encode(flat, tables).to_bytes()
        scale = tables.quant.scale.numpy()
    else:
        tables = ref_calibrate(flat, ref_ckpt.CKPT_CODEC_CONFIG,
                               max_windows=4096)
        blob = ref_encode(flat, tables).to_bytes()
        scale = np.asarray(tables.quant.scale)
    with open(final / f"{name}.fptc", "wb") as f:
        f.write(blob)
    manifest = {"step": 7, "version": 1, "leaves": {key: {
        "shape": list(arr.shape), "dtype": str(arr.dtype), "file": name,
        "codec": "fptc", "crc": zlib.crc32(blob),
        "aux": {"scale": scale.tolist(),
                "hist": np.asarray(tables.hist).tolist()},
    }}}
    with open(final / "manifest.json", "w") as f:
        json.dump(manifest, f)
    step, restored = ckpt.restore_latest(str(tmp_path), tree)
    assert step == 7
    assert _rel(restored["m"], arr) < REL_RMS


def test_compressed_save_needs_a_card_or_cpu(tmp_path, monkeypatch):
    """The blob's engines run on the card unless the caller asks for the
    CPU; a raw checkpoint needs no engine."""
    tree = {"m": _smooth(np.random.default_rng(6), (128, 64))}
    path = ckpt.save_checkpoint(str(tmp_path), 1, tree, compress=True,
                                device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.save_checkpoint(str(tmp_path), 2, tree, compress=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore_checkpoint(str(tmp_path), 1, tree)
    assert ckpt.latest_step(str(tmp_path)) == 1  # the failed save left none
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    ckpt.save_checkpoint(str(tmp_path), 3, tree)


# ---------------------------------------------------------------------------
# Interchange: either package's checkpoint restores in the other.
# ---------------------------------------------------------------------------
BF16_BITS = np.arange(-640, 640, 5, dtype=np.int16).reshape(16, 16)


def _trees():
    """One state as the reference holds it (numpy, bfloat16 through
    ml_dtypes) and as the port does (a torch bfloat16 tensor): two
    compressed leaves, a small float leaf, a bfloat16 leaf and an int32
    counter (the last three raw)."""
    rng = np.random.default_rng(8)
    base = {
        "p": {"w": _smooth(rng, (512, 64)) * 0.02, "b": _smooth(rng, (64,))},
        "m": [_smooth(rng, (256, 64)) * 1e-3],
        "step": np.array(42, np.int32),
    }
    ref = dict(base, h=np.asarray(jnp.asarray(BF16_BITS).view(
        jnp.bfloat16)))
    port = dict(base, h=torch.from_numpy(BF16_BITS.copy()).view(
        torch.bfloat16))
    return base, ref, port


COMPRESSED = [("p", "w"), ("m", 0)]


def _levels(path):
    """Per shard, the level grid of the v2 blob at ``path`` (the port's
    host decoder on the tables the manifest carries)."""
    state = _manifest(path)["state"]
    tables = tables_from_hist(
        ckpt.CKPT_CODEC_CONFIG, np.asarray(state["tables"]["scale"],
                                           np.float32),
        np.asarray(state["tables"]["hist"], np.int64),
        domain_id=state["domain_id"])
    raw = open(os.path.join(path, state["file"]), "rb").read()
    out = []
    for s in state["shards"]:
        c = Container.from_bytes(raw[s["offset"]:s["offset"] + s["size"]])
        syms = symlen.unpack_symlen_np(symlen.PackedStream(
            c.words, c.symlen.astype(np.int32), c.num_symbols), tables.book)
        out.append(syms.reshape(c.num_windows, c.e).astype(np.int64))
    return out


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The same state checkpointed by each package (compress=True)."""
    base, ref_tree, port_tree = _trees()
    root = tmp_path_factory.mktemp("interchange")
    ref_path = ref_ckpt.save_checkpoint(str(root / "ref"), 4, ref_tree,
                                        compress=True)
    port_path = ckpt.save_checkpoint(str(root / "port"), 4, port_tree,
                                     compress=True, device="cpu")
    return base, ref_tree, port_tree, ref_path, port_path


def test_manifests_name_leaves_alike(saved):
    _, _, _, ref_path, port_path = saved
    ref_m, port_m = _manifest(ref_path), _manifest(port_path)
    assert list(port_m["leaves"]) == list(ref_m["leaves"])
    assert port_m["leaves"].keys() == {
        "['h']", "['m'][0]", "['p']['b']", "['p']['w']", "['step']"}
    for key, want in ref_m["leaves"].items():
        got = port_m["leaves"][key]
        assert {k: v for k, v in got.items() if k != "crc"} == {
            k: v for k, v in want.items() if k != "crc"}, key
        if "file" not in want:
            continue
        if key == "['h']":  # the header spells bfloat16's void type '<V2'
            a, b = (np.load(os.path.join(p, want["file"] + ".npy"))
                    for p in (port_path, ref_path))
            assert a.tobytes() == b.tobytes()
        else:
            assert got["crc"] == want["crc"], key  # the same .npy bytes
    assert sorted(os.listdir(port_path)) == sorted(os.listdir(ref_path))
    ref_s, port_s = ref_m["state"], port_m["state"]
    assert port_s["leaves"] == ref_s["leaves"]  # keys, shapes, scales
    assert port_s["domain_id"] == ref_s["domain_id"]
    np.testing.assert_allclose(port_s["tables"]["scale"],
                               ref_s["tables"]["scale"], rtol=1e-5)
    ref_hist = np.asarray(ref_s["tables"]["hist"])
    hist_d = np.abs(np.asarray(port_s["tables"]["hist"]) - ref_hist).sum()
    assert hist_d <= 0.01 * ref_hist.sum()


def test_encodes_agree_by_the_flip_rule(saved):
    _, _, _, ref_path, port_path = saved
    got, want = _levels(port_path), _levels(ref_path)
    assert [g.shape for g in got] == [w.shape for w in want]
    d = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    assert d.max() <= 1
    assert (d > 0).sum() <= max(1.0, FLIP_SHARE * d.size), (d > 0).sum()


def test_reference_checkpoint_restores_in_port(saved):
    base, ref_tree, port_tree, ref_path, _ = saved
    step, got = ckpt.restore_latest(os.path.dirname(ref_path), port_tree,
                                    device="cpu")
    _, want = ref_ckpt.restore_latest(os.path.dirname(ref_path), ref_tree)
    assert step == 4
    assert got["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["h"].view(torch.int16).numpy(),
                                  BF16_BITS)
    for k in ("step",):
        assert got[k].dtype == base[k].dtype
        np.testing.assert_array_equal(got[k], base[k])
    np.testing.assert_array_equal(got["p"]["b"], base["p"]["b"])
    for a, b in COMPRESSED:
        g, w = got[a][b], np.asarray(want[a][b])
        assert g.dtype == np.float32 and g.shape == base[a][b].shape
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
        assert _rel(g, base[a][b]) < REL_RMS


def test_port_checkpoint_restores_in_reference(saved):
    base, ref_tree, _, _, port_path = saved
    step, got = ref_ckpt.restore_latest(os.path.dirname(port_path), ref_tree)
    assert step == 4
    assert str(got["h"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(got["h"]).view(np.int16),
                                  BF16_BITS)
    np.testing.assert_array_equal(got["step"], base["step"])
    np.testing.assert_array_equal(got["p"]["b"], base["p"]["b"])
    for a, b in COMPRESSED:
        assert np.asarray(got[a][b]).dtype == np.float32
        assert _rel(got[a][b], base[a][b]) < REL_RMS


def test_raw_bf16_leaf_round_trips_in_port(tmp_path):
    _, _, port_tree = _trees()
    ckpt.save_checkpoint(str(tmp_path), 1, port_tree)
    _, got = ckpt.restore_latest(str(tmp_path), port_tree)
    assert got["h"].dtype == torch.bfloat16  # bits compared: NaNs included
    assert torch.equal(got["h"].view(torch.int16), torch.from_numpy(BF16_BITS))
    like = dict(port_tree, h=np.zeros((16, 16), np.float32))
    _, host = ckpt.restore_latest(str(tmp_path), like)
    assert host["h"].dtype == torch.bfloat16  # numpy has no bfloat16


def test_tree_walk_matches_jax():
    """The port's walk gives JAX's leaf order and ``keystr`` strings (the
    checkpoint's leaf keys and file names) and rebuilds the structure."""
    import jax

    from repro_torch.core.tree import (
        tree_flatten_with_path,
        tree_leaves,
        tree_unflatten,
    )

    tree = {"b": [1, (2, {"z": 3, "a": 4})], "a": {"y": 5, "x": None},
            "n": {7: 6, 0: 8}, "c": ()}
    want = [(jax.tree_util.keystr(p), v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert tree_flatten_with_path(tree) == want
    assert tree_leaves(tree) == [v for _, v in want]
    back = tree_unflatten(tree, [v * 10 for _, v in want])
    assert back == jax.tree_util.tree_map(lambda v: v * 10, tree)
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(tree, list(range(8)))


# ---------------------------------------------------------------------------
# Resumes: the twin of test_checkpoint.py::test_resume_reproduces_
# uninterrupted_run, and a resume across the packages.
# ---------------------------------------------------------------------------
# a compressed resume: the final weights' distance from the uninterrupted
# run's, relative to the uninterrupted run's change over its 6 steps (m and
# v come back within REL_RMS, v negative in a tenth of its entries until
# AdamW.project lifts it); measured 0.124
RESUME_COMPRESSED_BOUND = 2.0 ** -2
# across the packages, the port's 3 steps after the reference's 3 against
# the reference's own: test_torch_train.py's trajectory bounds (each
# step's loss relative; the change over the 3 steps, all leaves, relative
# L2); measured 3.2e-4 and 0.072
TRAJ_LOSS_BOUND = 2.0 ** -8
TRAJ_CHANGE_BOUND = 2.0 ** -2
RESUME_OPT = dict(base_lr=1e-3, warmup=1, total_steps=20)


def _lm_batch(vocab: int, step: int):
    """``test_checkpoint.py``'s batch ``step``: seeded tokens as labels."""
    toks = np.random.default_rng(step).integers(0, vocab, (2, 16)).astype(
        np.int32)
    return toks, {"tokens": torch.from_numpy(toks),
                  "labels": torch.from_numpy(toks)}


def _port_trainer(arch: str, seed: int):
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.optimizer import AdamW, AdamWConfig
    from repro_torch.distributed.train import make_train_step
    from repro_torch.models import build_model

    model = build_model(get_smoke(arch), device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    ts = make_train_step(model, AdamW(AdamWConfig(**RESUME_OPT)), "cpu")
    return model, ts, ts.init()


def _weights(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("compress", [False, True])
def test_resume_reproduces_uninterrupted_run(tmp_path, compress):
    """3 steps, a checkpoint of the reference-layout train state, a
    "crash" (a model drawn from another seed, a fresh optimizer), the
    restore, 3 more steps: bit for bit the 6-step run's weights, m and v on
    the CPU; compressed, the weights within ``RESUME_COMPRESSED_BOUND``."""
    from repro_torch.models.convert import (
        load_train_state,
        train_state_tree,
    )

    arch = "qwen15_4b"
    model, ts, st = _port_trainer(arch, 0)
    start = _weights(model)
    vocab = model.cfg.vocab_size
    for s in range(6):
        st, _ = ts.step_fn(st, _lm_batch(vocab, s)[1])
    ref, ref_m, ref_v = _weights(model), st.m, st.v

    model, ts, st = _port_trainer(arch, 0)
    for s in range(3):
        st, _ = ts.step_fn(st, _lm_batch(vocab, s)[1])
    path = ckpt.save_checkpoint(str(tmp_path), 3, train_state_tree(model, st),
                                compress=compress, device="cpu")
    assert any(f.endswith(".fptc") for f in os.listdir(path)) == compress
    del model, ts, st

    model, ts, st = _port_trainer(arch, 7)  # the restart's own draw
    step, tree = ckpt.restore_latest(
        str(tmp_path), train_state_tree(model, st), device="cpu")
    assert step == 3
    st = load_train_state(tree, model, st, step, ts.optimizer)
    assert int(st.step) == 3 and st.step.dtype == torch.int32
    for s in range(3, 6):
        st, _ = ts.step_fn(st, _lm_batch(vocab, s)[1])
    got = _weights(model)
    if not compress:
        for name in ref:
            assert torch.equal(got[name], ref[name]), name
            assert torch.equal(st.m[name], ref_m[name]), name
            assert torch.equal(st.v[name], ref_v[name]), name
        return
    num = sum(float(torch.sum((got[n].float() - ref[n].float()) ** 2))
              for n in ref)
    den = sum(float(torch.sum((ref[n].float() - start[n].float()) ** 2))
              for n in ref)
    assert (num / den) ** 0.5 <= RESUME_COMPRESSED_BOUND


def test_resume_from_a_reference_checkpoint(tmp_path):
    """The JAX package trains 3 steps and writes its train-state checkpoint
    (``{"params", "m", "v"}``, stacked layers); the port restores it into
    its model and optimizer and takes 3 more steps, tracking the JAX
    package's own 6-step run within the trajectory bounds."""
    import jax

    from repro.configs import get_smoke as ref_get_smoke
    from repro.distributed.optimizer import AdamW as RefAdamW
    from repro.distributed.optimizer import AdamWConfig as RefAdamWConfig
    from repro.models import build_model as ref_build_model
    from repro.models.common import init_params as ref_init_params
    from repro_torch.models.convert import (
        load_train_state,
        train_state_tree,
    )

    arch = "granite_8b"
    rcfg = ref_get_smoke(arch)
    rm = ref_build_model(rcfg)
    opt = RefAdamW(RefAdamWConfig(**RESUME_OPT))

    @jax.jit
    def step_fn(p, st, b):
        loss, g = jax.value_and_grad(rm.loss)(p, b)
        p2, st2, _ = opt.update(p, st, g)
        return p2, st2, loss

    params = ref_init_params(rm.param_specs(), jax.random.PRNGKey(0))
    st, losses, mid = opt.init(params), [], None
    for s in range(6):
        toks = _lm_batch(rcfg.vocab_size, s)[0]
        params, st, loss = step_fn(params, st, {"tokens": toks,
                                                "labels": toks})
        losses.append(float(loss))
        if s == 2:
            mid = jax.tree_util.tree_map(np.asarray, {
                "params": params, "m": st.m, "v": st.v})
            ref_ckpt.save_checkpoint(str(tmp_path), 3, mid)
    final = jax.tree_util.tree_map(np.asarray, params)

    model, ts, pst = _port_trainer(arch, 7)
    step, tree = ckpt.restore_latest(
        str(tmp_path), train_state_tree(model, pst), device="cpu")
    pst = load_train_state(tree, model, pst, step, ts.optimizer)
    port_losses = []
    for s in range(3, 6):
        pst, metrics = ts.step_fn(pst, _lm_batch(rcfg.vocab_size, s)[1])
        port_losses.append(float(metrics["loss"]))
    for got, want in zip(port_losses, losses[3:]):
        assert abs(got - want) <= TRAJ_LOSS_BOUND * abs(want), (
            port_losses, losses[3:])
    mine = train_state_tree(model, pst)["params"]
    d_port, d_ref = [], []
    for (p, want), (_, at3) in zip(
            jax.tree_util.tree_flatten_with_path(final)[0],
            jax.tree_util.tree_flatten_with_path(mid["params"])[0]):
        got = mine
        for k in p:
            got = got[k.key]
        base = np.asarray(at3, np.float32)
        d_port.append((got.float().numpy() - base).ravel())
        d_ref.append((np.asarray(want, np.float32) - base).ravel())
    dp, dr = np.concatenate(d_port), np.concatenate(d_ref)
    assert np.linalg.norm(dp - dr) / np.linalg.norm(dr) <= TRAJ_CHANGE_BOUND
