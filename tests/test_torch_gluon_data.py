"""The port's ``gluon.data`` and ``gluon.utils`` against the JAX
package's, on the CPU.

Datasets (``SimpleDataset``, ``ArrayDataset``, the lazy and eager
``transform`` and ``transform_first``), samplers (sequential, random
from one numpy seed, ``BatchSampler`` with every ``last_batch`` over two
epochs) and ``DataLoader`` batches (shuffled from one seed, with and
without worker threads, NDArray and numpy samples) equal the JAX
package's exactly; ``split_data``/``split_and_load`` give the same slices
on the contexts asked for; ``clip_global_norm`` gives the same norm and
scaled arrays (rtol 1e-6, f32); ``check_sha1`` reads a local file;
``download`` and ``RecordFileDataset`` raise.
"""
import hashlib

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon import utils as jutils
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon import utils as tutils

CPU = mxt.cpu()
X = np.arange(42, dtype=np.float32).reshape(14, 3)
Y = np.arange(14, dtype=np.float32) * 10


def _np(v):
    if isinstance(v, (list, tuple)):
        return [_np(x) for x in v]
    return v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)


def _equal(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_batch_sampler_matches_jax(last_batch):
    got = tdata.BatchSampler(tdata.SequentialSampler(10), 4, last_batch)
    want = jdata.BatchSampler(jdata.SequentialSampler(10), 4, last_batch)
    for _ in range(2):                  # rollover carries into epoch 2
        assert len(got) == len(want)
        assert [list(map(int, b)) for b in got] == \
            [list(map(int, b)) for b in want]
    with pytest.raises(ValueError):
        tdata.BatchSampler(tdata.SequentialSampler(3), 2, "drop")


def test_random_sampler_follows_numpy_seed():
    np.random.seed(4)
    want = list(jdata.RandomSampler(14))
    np.random.seed(4)
    got = list(tdata.RandomSampler(14))
    assert got == want and sorted(got) == list(range(14))
    assert list(tdata.SequentialSampler(5)) == list(range(5))


def test_datasets_and_transforms_match_jax():
    jds = jdata.ArrayDataset(mx.nd.array(X), Y)
    tds = tdata.ArrayDataset(mxt.nd.array(X, ctx=CPU), Y)
    assert len(tds) == len(jds) == 14
    for i in (0, 5, 13):
        _equal(tds[i], jds[i])
    for lazy in (True, False):
        j = jds.transform(lambda x, y: (x * 2.0, y + 1), lazy=lazy)
        t = tds.transform(lambda x, y: (x * 2.0, y + 1), lazy=lazy)
        j1 = jds.transform_first(lambda x: x + 1.0, lazy=lazy)
        t1 = tds.transform_first(lambda x: x + 1.0, lazy=lazy)
        for i in (1, 7):
            _equal(t[i], j[i])
            _equal(t1[i], j1[i])
    simple = tdata.SimpleDataset(list(range(6)))
    assert len(simple) == 6 and simple[4] == 4
    assert simple.transform(lambda v: v * v)[3] == 9
    one = tdata.ArrayDataset(X)
    _equal(one[2], X[2])
    with pytest.raises(mxt.MXNetError, match="same length"):
        tdata.ArrayDataset(X, Y[:5])


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_dataloader_matches_jax(workers, last_batch):
    jds = jdata.ArrayDataset(mx.nd.array(X), Y)
    tds = tdata.ArrayDataset(mxt.nd.array(X, ctx=CPU), Y)
    np.random.seed(11)
    want = [_np(b) for b in jdata.DataLoader(
        jds, batch_size=4, shuffle=True, last_batch=last_batch,
        num_workers=workers)]
    np.random.seed(11)
    loader = tdata.DataLoader(tds, batch_size=4, shuffle=True,
                              last_batch=last_batch, num_workers=workers)
    n = len(loader)         # before the epoch: rollover carries into the next
    got = [_np(b) for b in loader]
    assert len(got) == len(want) == n
    _equal(got, want)
    batch = next(iter(tdata.DataLoader(tds, batch_size=4)))
    assert batch[0].context == CPU and batch[0].shape == (4, 3)


def test_dataloader_arguments_and_batchify():
    ds = tdata.SimpleDataset([np.float32(i) for i in range(7)])
    out = list(tdata.DataLoader(ds, batch_size=3))
    _equal(out, [np.array([0., 1., 2.]), np.array([3., 4., 5.]),
                 np.array([6.])])
    sampler = tdata.BatchSampler(tdata.SequentialSampler(7), 2, "discard")
    assert len(tdata.DataLoader(ds, batch_sampler=sampler)) == 3
    with pytest.raises(ValueError):
        tdata.DataLoader(ds)
    with pytest.raises(ValueError):
        tdata.DataLoader(ds, batch_size=2, batch_sampler=sampler)
    with pytest.raises(ValueError):
        tdata.DataLoader(ds, batch_size=2, shuffle=True,
                         sampler=tdata.SequentialSampler(7))
    stacked = tdata.dataloader.default_batchify_fn(
        [mxt.nd.array(X[i], ctx=CPU) for i in range(3)])
    _equal(stacked, jdata.dataloader.default_batchify_fn(
        [mx.nd.array(X[i]) for i in range(3)]))


@pytest.mark.parametrize("batch_axis,even", [(0, True), (1, False),
                                             (0, False)])
def test_split_data_matches_jax(batch_axis, even):
    x = np.arange(60, dtype=np.float32).reshape(5, 12) if batch_axis \
        else np.arange(60, dtype=np.float32).reshape(12, 5)
    n = 3 if even else 5
    got = tutils.split_data(mxt.nd.array(x, ctx=CPU), n, batch_axis, even)
    want = jutils.split_data(mx.nd.array(x), n, batch_axis, even)
    _equal(got, want)
    with pytest.raises(ValueError):
        tutils.split_data(mxt.nd.array(x, ctx=CPU), 13, 0)


def test_split_and_load_matches_jax():
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    got = tutils.split_and_load(x, [CPU, mxt.cpu(1)])
    want = jutils.split_and_load(x, [mx.cpu(), mx.cpu(1)], sharded=False)
    _equal(got, want)
    assert [a.context for a in got] == [CPU, mxt.cpu(1)]
    one = tutils.split_and_load(mxt.nd.array(x, ctx=CPU), [CPU])
    assert len(one) == 1 and one[0].shape == (8, 3)
    with pytest.raises(mxt.MXNetError, match="sharded"):
        tutils.split_and_load(x, [CPU, mxt.cpu(1)], sharded=True)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_global_norm_matches_jax(max_norm):
    rng = np.random.RandomState(2)
    values = [rng.randn(3, 4).astype(np.float32),
              rng.randn(5).astype(np.float32)]
    jarr = [mx.nd.array(v) for v in values]
    tarr = [mxt.nd.array(v, ctx=CPU) for v in values]
    keep = [a.data for a in tarr]
    jn = jutils.clip_global_norm(jarr, max_norm)
    tn = tutils.clip_global_norm(tarr, max_norm)
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
    for a, b, t in zip(tarr, jarr, keep):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6,
                                   atol=1e-7)
        assert a.data is t             # scaled in place
    if max_norm < tn:
        total = np.sqrt(sum((a.asnumpy() ** 2).sum() for a in tarr))
        np.testing.assert_allclose(total, max_norm, rtol=1e-5)


def test_check_sha1_download_and_record_files(tmp_path):
    path = tmp_path / "blob.bin"
    path.write_bytes(b"gluon data" * 100)
    digest = hashlib.sha1(path.read_bytes()).hexdigest()
    assert tutils.check_sha1(str(path), digest)
    assert tutils.check_sha1(str(path), digest) == \
        jutils.check_sha1(str(path), digest)
    assert not tutils.check_sha1(str(path), "0" * 40)
    url = "https://example.invalid/files/blob.bin"
    assert tutils.download(url, path=str(tmp_path), sha1_hash=digest) == \
        str(path)
    with pytest.raises(mxt.MXNetError, match="network"):
        tutils.download(url, path=str(tmp_path / "missing.bin"))
    with pytest.raises(mxt.MXNetError, match="RecordIO"):
        tdata.RecordFileDataset(str(tmp_path / "images.rec"))
