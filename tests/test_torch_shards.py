"""The port's multi-device shard split (``serving.engine``'s scheduler and
splits, the engines' ``devices=``) held against the JAX package's.

The scheduler and split units take the reference's cases and compare the
port's schedules with the reference's on the same keys and costs.  The
sharded engines run on the CPU with a repeated device
(``devices=("cpu",) * k``, k in 1..3): every shard count gives the one-shard
bytes exactly — decoded samples bit for bit, containers byte for byte —
and the one-shard results are held to the reference by the port's existing
rules: decoded samples within ``max|d| <= 1e-5 * max|ref|`` of the
reference's XLA engine (its own arms differ by about 1 ulp, R2); encoded
containers equal to the reference's XLA engine's byte for byte wherever
the level grids agree, and otherwise by the flip rule of
``tests/test_torch_transcode.py`` (torch's and XLA's CPU DCTs sum in
different orders, so a coefficient on a cell boundary may land one level
away); and the transcode equal to the port's own round trip byte for byte.
"""
import dataclasses

import pytest

pytest.importorskip("jax")  # the reference; absent on the card

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import codec as ref_codec  # noqa: E402
from repro.core.calibration import calibrate as ref_calibrate  # noqa: E402
from repro.core.config import DOMAIN_DEFAULTS  # noqa: E402
from repro.data import make_signal  # noqa: E402
from repro.serving import BatchDecoder as RefBatchDecoder  # noqa: E402
from repro.serving import BatchEncoder as RefBatchEncoder  # noqa: E402
from repro.serving import engine as ref_engine  # noqa: E402
from repro_torch.core.calibration import tables_from_arrays  # noqa: E402
from repro_torch.core.container import Container  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    BatchDecoder,
    BatchEncoder,
    BucketScheduler,
    Transcoder,
    serving_devices,
)
from repro_torch.serving.engine import (  # noqa: E402
    PipelineExecutor,
    _split_balanced,
    _split_contiguous,
    member_positions,
)
from test_torch_transcode import assert_matches_reference  # noqa: E402

CPU = torch.device("cpu")
REL_TOL = 1e-5
CHUNK = 64


def _schedule(buckets):
    return [(b.key, b.shard, b.device, list(b.items)) for b in buckets]


# ---------------------------------------------------------------------------
# Scheduler units (the reference's cases, and the reference's schedules).
# ---------------------------------------------------------------------------
def test_group_by_first_appearance_order():
    order, groups = BucketScheduler.group_by(["b", "a", "b", "c", "a"])
    assert order == ["b", "a", "c"]
    assert groups == {"b": [0, 2], "a": [1, 4], "c": [3]}


def test_buckets_single_shard_matches_grouping():
    sched = BucketScheduler(devices=None)
    buckets = sched.buckets(["x", "y", "x", "x"])
    assert [(b.key, list(b.items)) for b in buckets] == [
        ("x", [0, 2, 3]), ("y", [1])
    ]
    assert all(b.shard == 0 and b.device is None for b in buckets)
    assert member_positions(buckets, 4) == [0, 3, 1, 2]


def test_buckets_contiguous_balanced_shards():
    # fake "devices": scheduling never touches them
    sched = BucketScheduler(devices=["d0", "d1"])
    assert sched.num_shards == 2 and sched.device_of(1) == "d1"
    buckets = sched.buckets(["x"] * 5 + ["y"])
    assert [(b.key, b.shard, list(b.items)) for b in buckets] == [
        ("x", 0, [0, 1, 2]), ("x", 1, [3, 4]), ("y", 0, [5])
    ]
    assert buckets[1].device == "d1"
    # flattened member order is still group-major, members in input order
    assert member_positions(buckets, 6) == [0, 1, 2, 3, 4, 5]


def test_buckets_rotate_start_shard_across_groups():
    """Many small groups spread over every device: the starting shard
    rotates, instead of every single-member group landing on shard 0."""
    sched = BucketScheduler(devices=["d0", "d1", "d2", "d3"])
    buckets = sched.buckets(["a", "b", "c", "d", "e"])
    assert [b.shard for b in buckets] == [0, 1, 2, 3, 0]


def test_buckets_pinned_shard_ids():
    sched = BucketScheduler(devices=["d0", "d1", "d2"])
    buckets = sched.buckets(["x", "x", "x", "y"], shard_ids=[2, 0, 2, 1])
    assert [(b.key, b.shard, list(b.items)) for b in buckets] == [
        ("x", 0, [1]), ("x", 2, [0, 2]), ("y", 1, [3])
    ]
    # a foreign scheduler's ids map through shard_devices
    mapped = BucketScheduler(devices=None).buckets(
        ["x", "x"], shard_ids=[5, 5], shard_devices={5: "d5"})
    assert _schedule(mapped) == [("x", 5, "d5", [0, 1])]


def test_pinned_shard_without_device_mapping_raises():
    sched = BucketScheduler(devices=None)
    with pytest.raises(ValueError, match="shard_devices"):
        sched.buckets(["x", "x"], shard_ids=[0, 3])


def test_scheduler_round_follows_policy(monkeypatch):
    monkeypatch.delenv("FPTC_BUCKET_POLICY", raising=False)
    assert BucketScheduler(devices=None).round(5) == 8  # p2 default
    assert BucketScheduler(devices=None, policy="half-octave").round(5) == 6
    assert BucketScheduler(devices=None, policy="cost-balanced").round(5) == 5
    sched = BucketScheduler(devices=None, policy="half-octave")
    for x in (1, 2, 3, 7, 100, 1000):
        r = sched.round(x)
        assert r >= x
        assert sched.round(r) == r  # idempotent on edges


def test_split_balanced_equal_costs_stay_balanced():
    parts = _split_balanced(list(range(10)), [1.0] * 10, 4)
    assert sum(parts, []) == list(range(10))  # contiguous, order kept
    sizes = sorted(len(p) for p in parts)
    assert len(parts) == 4 and sizes[-1] - sizes[0] <= 1


def test_split_balanced_isolates_heavy_item():
    # one item worth more than everything else combined gets its own shard
    parts = _split_balanced([0, 1, 2, 3], [100.0, 1.0, 1.0, 1.0], 2)
    assert parts == [[0], [1, 2, 3]]


def test_split_balanced_degenerate_falls_back():
    assert _split_balanced([0, 1], [1.0, 1.0], 1) == (
        _split_contiguous([0, 1], 1))
    assert _split_balanced([0, 1], [0.0, 0.0], 2) == (
        _split_contiguous([0, 1], 2))


def test_buckets_cost_balanced_shard_split():
    sched = BucketScheduler(devices=["d0", "d1"])
    buckets = sched.buckets(
        ["x", "x", "x", "x"], item_costs=[100.0, 1.0, 1.0, 1.0]
    )
    assert [(b.shard, list(b.items)) for b in buckets] == [
        (0, [0]), (1, [1, 2, 3])
    ]


@pytest.mark.parametrize("num_shards", [1, 2, 3, 5])
def test_splits_and_schedules_match_reference(num_shards):
    """Both splits and whole schedules (rotation, cost balance, pinning)
    equal the reference's on the same keys and costs."""
    rng = np.random.default_rng(num_shards)
    items = list(range(23))
    costs = rng.exponential(size=23).round(3).tolist()
    assert _split_contiguous(items, num_shards) == (
        ref_engine._split_contiguous(items, num_shards))
    assert _split_balanced(items, costs, num_shards) == (
        ref_engine._split_balanced(items, costs, num_shards))
    devs = [f"d{i}" for i in range(num_shards)]
    keys = rng.integers(0, 4, size=23).tolist()
    ref = ref_engine.BucketScheduler(devices=devs, policy="p2")
    port = BucketScheduler(devices=devs, policy="p2")
    for kw in ({}, {"item_costs": costs},
               {"shard_ids": rng.integers(0, num_shards, 23).tolist()}):
        assert _schedule(port.buckets(keys, **kw)) == (
            _schedule(ref.buckets(keys, **kw)))


def test_serving_devices_resolution(monkeypatch):
    assert serving_devices(None, device="cpu") == (CPU,)
    assert serving_devices(["cpu", "cpu"]) == (CPU, CPU)
    assert serving_devices(("cpu",), device="cpu") == (CPU,)
    with pytest.raises(ValueError, match="non-empty"):
        serving_devices([])
    with pytest.raises(ValueError, match="unsupported device"):
        serving_devices(["meta"])
    # no device means the card, here as everywhere: no quiet CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_devices(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_devices("auto")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchDecoder(devices="auto")


def test_device_and_devices_must_agree(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="disagree"):
        BatchDecoder(device="cuda", devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="disagree"):
        BatchEncoder(device="cpu", devices=["cpu", "cuda:0"])
    monkeypatch.undo()
    dec = BatchDecoder(device="cpu", devices=["cpu", "cpu"])
    assert dec.devices == (CPU, CPU) and dec.device == CPU
    assert dec.scheduler.num_shards == 2


def test_repeated_device_shares_one_executor():
    """A device named twice is one executor device: one staging worker,
    one set of host buffers, no second side stream."""
    ex = PipelineExecutor([CPU, CPU, CPU])
    assert ex.devices == (CPU,) and ex.device == CPU and not ex.cuda
    dec = BatchDecoder(devices=["cpu"] * 3)
    assert dec.executor.devices == (CPU,)


def test_mismatched_transcoder_devices_raise():
    with pytest.raises(ValueError, match="same devices"):
        Transcoder(
            decoder=BatchDecoder(device="cpu"),
            encoder=BatchEncoder(devices=["cpu", "cpu"]),
        )


# ---------------------------------------------------------------------------
# Sharded engines: every shard count gives the one-shard bytes.
# ---------------------------------------------------------------------------
def carry(ref_tables):
    q = ref_tables.quant
    return tables_from_arrays(
        dataclasses.asdict(ref_tables.config), ref_tables.domain_id,
        zone=np.asarray(q.zone), scale=np.asarray(q.scale), mu=float(q.mu),
        alpha1=float(q.alpha1), lengths=np.asarray(ref_tables.book.lengths),
    )


@pytest.fixture(scope="module")
def archive():
    """Two domains (power and meteorological, the reference engine test's)
    with four signals each of one length per domain, interleaved: (signals,
    domain ids, reference containers' bytes, reference tables, port
    tables)."""
    ref_tables, sigs, doms = {}, [], []
    for d, (dom, ds, length) in enumerate([
        ("power", "load_power", 1500), ("meteorological", "temperature", 777),
    ]):
        ref_tables[d] = ref_calibrate(make_signal(ds, 65536, seed=7 + d),
                                      DOMAIN_DEFAULTS[dom], domain_id=d)
        for i in range(4):
            sigs.append(make_signal(ds, length, seed=90 + 8 * d + i))
            doms.append(d)
    order = [0, 4, 1, 5, 2, 6, 3, 7]
    sigs = [sigs[i] for i in order]
    doms = [doms[i] for i in order]
    blobs = [ref_codec.encode(s, ref_tables[d]).to_bytes()
             for s, d in zip(sigs, doms)]
    port_tables = {k: carry(t) for k, t in ref_tables.items()}
    return sigs, doms, blobs, ref_tables, port_tables


@pytest.fixture(scope="module")
def one_shard(archive):
    """The one-shard results on the CPU, held to the reference once."""
    from repro.core.container import Container as RefContainer

    sigs, doms, blobs, ref_tables, port_tables = archive
    cs = [Container.from_bytes(b) for b in blobs]
    dec = BatchDecoder(device="cpu").decode(cs, port_tables).to_host()
    ref_dec = RefBatchDecoder(use_kernels=False, devices=None).decode(
        [RefContainer.from_bytes(b) for b in blobs], ref_tables).to_host()
    for got, want in zip(dec, ref_dec):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()
    enc_cs = BatchEncoder(chunk_size=CHUNK, device="cpu").encode(
        sigs, port_tables, domain_ids=doms).to_host()
    ref_enc = RefBatchEncoder(chunk_size=CHUNK, use_kernels=False,
                              devices=None).encode_to_host(
        sigs, ref_tables, domain_ids=doms)
    assert_matches_reference(
        enc_cs, [Container.from_bytes(c.to_bytes()) for c in ref_enc],
        port_tables)
    enc = [c.to_bytes() for c in enc_cs]
    tc = [c.to_bytes() for c in Transcoder(
        chunk_size=CHUNK, device="cpu").transcode_to_host(
            cs, port_tables, port_tables[1], dst_domain_ids=[1] * len(cs))]
    # the port's transcode is its own round trip, byte for byte
    rt = BatchEncoder(chunk_size=CHUNK, device="cpu").encode(
        dec, port_tables[1]).to_host()
    assert tc == [c.to_bytes() for c in rt]
    return cs, dec, enc, tc


@pytest.mark.parametrize("k", [1, 2, 3])
def test_sharded_engines_byte_identical(archive, one_shard, k):
    """Decode, encode and transcode over ``("cpu",) * k``: the one-shard
    bytes, with the batch axis really split (a bucket per (group, shard))
    and every bucket carrying its shard."""
    sigs, doms, _, _, port_tables = archive
    cs, dec_ref, enc_ref, tc_ref = one_shard
    devs = ("cpu",) * k

    dec = BatchDecoder(devices=devs)
    got = dec.decode(cs, port_tables).to_host()
    for a, b in zip(got, dec_ref):
        np.testing.assert_array_equal(a, b)
    assert dec.stats.dispatches == 2 * k  # two groups of four, k shards
    assert sorted({p["shard"] for p in dec.stats.bucket_pad}) == list(
        range(k))

    enc = BatchEncoder(devices=devs, chunk_size=CHUNK)
    batch = enc.encode(sigs, port_tables, domain_ids=doms)
    assert sorted(p.shard for p in batch.device_parts()) == sorted(
        list(range(k)) * 2)
    assert all(p.device == CPU for p in batch.device_parts())
    assert [c.to_bytes() for c in batch.to_host()] == enc_ref
    assert enc.stats.dispatches == 2 * k

    tc = Transcoder(devices=devs, chunk_size=CHUNK)
    got_tc = tc.transcode_to_host(cs, port_tables, port_tables[1],
                                  dst_domain_ids=[1] * len(cs))
    assert [c.to_bytes() for c in got_tc] == tc_ref
    # every re-encode bucket is pinned to the shard that decoded its rows
    assert tc.encoder.stats.dispatches >= k


@pytest.mark.parametrize("k", [2, 3])
def test_sharded_encoded_batch_transcode(archive, one_shard, k):
    """An EncodedBatch source sharded over k devices: each shard's parts
    stitch, decode and re-encode where they lie — into a k-shard
    transcoder, and into a one-device one (placement follows the data) —
    with the one-shard pipeline's bytes."""
    sigs, doms, _, _, port_tables = archive

    def run(src_devs, tc_devs):
        batch = BatchEncoder(devices=src_devs, chunk_size=CHUNK).encode(
            sigs, port_tables, domain_ids=doms)
        return [c.to_bytes() for c in Transcoder(
            devices=tc_devs, chunk_size=CHUNK).transcode_to_host(
                batch, port_tables, port_tables[1],
                dst_domain_ids=[1] * len(sigs))]

    want = run(("cpu",), ("cpu",))
    assert run(("cpu",) * k, ("cpu",) * k) == want
    assert run(("cpu",) * k, ("cpu",)) == want


def test_cost_balanced_split_follows_signal_cost(archive):
    """Two shards split a decode group at the cost model's boundary, not
    at equal counts: one heavy container and three light ones put the
    heavy one on a shard of its own; encode and decode keep the one-shard
    bytes."""
    _, _, _, _, port_tables = archive
    tab = port_tables[0]
    sigs = [make_signal("load_power", n, seed=40 + i)
            for i, n in enumerate([8192, 256, 256, 256])]
    enc = BatchEncoder(devices=("cpu", "cpu"), chunk_size=CHUNK)
    got = enc.encode(sigs, tab).to_host()
    want = BatchEncoder(device="cpu", chunk_size=CHUNK).encode(
        sigs, tab).to_host()
    assert [c.to_bytes() for c in got] == [c.to_bytes() for c in want]
    dec = BatchDecoder(devices=("cpu", "cpu"))
    out = dec.decode(want, tab).to_host()
    one = BatchDecoder(device="cpu").decode(want, tab).to_host()
    for a, b in zip(out, one):
        np.testing.assert_array_equal(a, b)
    shards = {p["shard"]: p["words"] for p in dec.stats.bucket_pad}
    # the heavy container alone on shard 0, the three light ones on 1
    assert len(shards) == 2 and shards[0] > shards[1]
    assert [p["windows"] for p in dec.stats.bucket_pad] == [
        8192 // 32, 3 * 256 // 32]
