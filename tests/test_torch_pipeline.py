"""The port's data pipelines (``repro_torch.data.pipeline``) held against
the reference's numpy twins: the same strips, calibration strips and token
batches, bit for bit, for every host shard and step — and the reference's
own properties (disjoint host shards, restartable batches).  Neither
package's data modules import JAX."""
import itertools

import numpy as np
import pytest

from repro.data import SignalPipeline as RefSignalPipeline
from repro.data import TokenPipeline as RefTokenPipeline
from repro_torch.data import SignalPipeline, TokenPipeline

DATASETS = ["mitbih", "seismic", "load_power", "temperature"]


@pytest.mark.parametrize("dataset", DATASETS)
def test_signal_strips_equal_the_reference(dataset):
    for host, hosts in ((0, 1), (1, 4), (3, 4)):
        kw = dict(strip_length=1024, host_id=host, num_hosts=hosts, seed=5)
        got, want = SignalPipeline(dataset, **kw), RefSignalPipeline(
            dataset, **kw)
        for i in (0, 1, 7):
            a, b = got.strip(i), want.strip(i)
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(itertools.islice(got, 3),
                        itertools.islice(want, 3)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("dataset", DATASETS)
def test_calibration_strips_equal_the_reference(dataset):
    """The held-out strip draws from ``seed - 1000003``: equal for a seed
    past that offset, and a ``ValueError`` from numpy in both packages
    below it (a negative seed)."""
    kw = dict(strip_length=1024, seed=2_000_000)
    got, want = SignalPipeline(dataset, **kw), RefSignalPipeline(
        dataset, **kw)
    assert np.array_equal(got.calibration_strip(512),
                          want.calibration_strip(512))
    assert np.array_equal(got.calibration_strip(), want.calibration_strip())
    for pipe in (SignalPipeline(dataset), RefSignalPipeline(dataset)):
        with pytest.raises(ValueError):
            pipe.calibration_strip()


def test_signal_pipeline_host_sharding_disjoint():
    strips = [SignalPipeline("mitbih", strip_length=1024, host_id=h,
                             num_hosts=4).strip(0) for h in range(4)]
    for a, b in itertools.combinations(strips, 2):
        assert not np.array_equal(a, b)


@pytest.mark.parametrize("host,hosts", [(0, 1), (1, 2)])
def test_token_batches_equal_the_reference(host, hosts):
    kw = dict(vocab_size=1000, batch_size=2, seq_len=16, host_id=host,
              num_hosts=hosts, seed=3)
    got, want = TokenPipeline(**kw), RefTokenPipeline(**kw)
    for step in (0, 1, 9):
        for a, b in zip(got.batch(step), want.batch(step)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for (x, y), (rx, ry) in zip(itertools.islice(got, 2),
                                itertools.islice(want, 2)):
        assert np.array_equal(x, rx) and np.array_equal(y, ry)


def test_token_pipeline_restartable_and_shifted():
    p = TokenPipeline(vocab_size=1000, batch_size=2, seq_len=16)
    x, y = p.batch(5)
    x2, y2 = TokenPipeline(vocab_size=1000, batch_size=2,
                           seq_len=16).batch(5)
    assert np.array_equal(x, x2) and np.array_equal(y, y2)
    assert np.array_equal(x[:, 1:], y[:, :-1])
    assert x.min() >= 0 and x.max() < 1000
