"""The file, resizing and prefetching iterators of the port against the
JAX package's, on the CPU.

``MNISTIter`` (idx files the test writes, plain and gzipped, flat and
not, shuffled under one numpy seed), ``CSVIter`` (with and without a
label file, ``round_batch`` on and off), ``LibSVMIter`` (dense batches,
as in the JAX package), ``ResizeIter`` and ``PrefetchingIter`` go over
the same files in both packages: every batch's data, label and pad are
equal (the values are copies, so bit for bit), over two epochs. The
prefetching iterator reports under the JAX package's telemetry names,
raises its wrapped iterator's error in the consumer, and leaves no
producer thread behind after an epoch, a ``reset`` or being dropped.
"""
import gc
import gzip
import struct
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt


def _write_idx(path, arr, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def _epochs(it, n=2):
    """Every batch of ``n`` epochs as numpy (data, label, pad)."""
    out = []
    for _ in range(n):
        for batch in it:
            out.append(([d.asnumpy() for d in batch.data],
                        [lb.asnumpy() for lb in batch.label or []],
                        batch.pad))
        it.reset()
    return out


def _same(got, want):
    assert len(got) == len(want) > 0
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for a, b in zip(gd + gl, wd + wl):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _both(make, seed=0):
    runs = []
    for pkg in (mx, mxt):
        np.random.seed(seed)
        runs.append(_epochs(make(pkg)))
    return runs


@pytest.fixture
def mnist_files(tmp_path):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (23, 6, 5))
    labels = rng.randint(0, 10, 23)
    paths = {}
    for gz in (False, True):
        suffix = ".gz" if gz else ""
        img = str(tmp_path / ("images-idx3-ubyte" + suffix))
        lbl = str(tmp_path / ("labels-idx1-ubyte" + suffix))
        _write_idx(img, images, gz)
        _write_idx(lbl, labels, gz)
        paths[gz] = (img, lbl)
    return paths


@pytest.mark.parametrize("gz", [False, True], ids=["idx", "gz"])
@pytest.mark.parametrize("flat", [False, True], ids=["image", "flat"])
def test_mnist_iter(mnist_files, gz, flat):
    img, lbl = mnist_files[gz]
    got, want = _both(lambda pkg: pkg.io.MNISTIter(
        image=img, label=lbl, batch_size=5, shuffle=True, flat=flat))
    _same(got, want)
    assert got[0][0][0].shape == ((5, 30) if flat else (5, 1, 6, 5))


def test_mnist_iter_finds_the_gz_file(mnist_files):
    img, lbl = mnist_files[True]
    got = _epochs(mxt.io.MNISTIter(image=img[:-3], label=lbl[:-3],
                                   batch_size=8, shuffle=False), 1)
    want = _epochs(mx.io.MNISTIter(image=img, label=lbl, batch_size=8,
                                   shuffle=False), 1)
    _same(got, want)


@pytest.mark.parametrize("labels", [False, True], ids=["nolabel", "label"])
@pytest.mark.parametrize("round_batch", [True, False],
                         ids=["round", "discard"])
def test_csv_iter(tmp_path, labels, round_batch):
    rng = np.random.RandomState(1)
    data = str(tmp_path / "data.csv")
    np.savetxt(data, rng.randn(11, 6), delimiter=",")
    label = None
    if labels:
        label = str(tmp_path / "label.csv")
        np.savetxt(label, rng.randint(0, 3, 11), delimiter=",")
    got, want = _both(lambda pkg: pkg.io.CSVIter(
        data_csv=data, data_shape=(2, 3), label_csv=label, batch_size=4,
        round_batch=round_batch))
    _same(got, want)
    assert len(got) == (6 if round_batch else 4)


def test_libsvm_iter(tmp_path):
    path = str(tmp_path / "data.libsvm")
    rng = np.random.RandomState(2)
    with open(path, "w") as f:
        for _ in range(9):
            cols = sorted(rng.choice(12, 4, replace=False))
            f.write("%d %s\n" % (rng.randint(0, 2), " ".join(
                "%d:%.4f" % (c, rng.randn()) for c in cols)))
        f.write("\n")
    got, want = _both(lambda pkg: pkg.io.LibSVMIter(
        data_libsvm=path, data_shape=(12,), batch_size=4, shuffle=True))
    _same(got, want)
    assert got[0][0][0].shape == (4, 12)


def _base(pkg):
    x = np.arange(70, dtype=np.float32).reshape(14, 5)
    y = np.arange(14, dtype=np.float32)
    return pkg.io.NDArrayIter(x, y, batch_size=4, shuffle=True)


@pytest.mark.parametrize("size", [2, 7])
def test_resize_iter(size):
    got, want = _both(lambda pkg: pkg.io.ResizeIter(_base(pkg), size))
    _same(got, want)
    assert len(got) == 2 * size


def test_prefetching_iter_matches_jax_and_renames():
    got, want = _both(lambda pkg: pkg.io.PrefetchingIter(_base(pkg)))
    _same(got, want)
    it = mxt.io.PrefetchingIter(_base(mxt), rename_data=[{"data": "x"}],
                                rename_label=[{"softmax_label": "y"}])
    ref = mx.io.PrefetchingIter(_base(mx), rename_data=[{"data": "x"}],
                                rename_label=[{"softmax_label": "y"}])
    assert [tuple(d) for d in it.provide_data] == \
        [tuple(d) for d in ref.provide_data] == [("x", (4, 5))]
    assert [d.name for d in it.provide_label] == ["y"]
    list(it)
    list(ref)


def test_prefetching_iter_telemetry_names():
    it = mxt.io.PrefetchingIter(_base(mxt))
    list(it)
    text = mxt.telemetry.dumps()
    for name in ('prefetch_wait_seconds_count{side="consumer"}',
                 'prefetch_wait_seconds_count{side="producer"}',
                 "prefetch_queue_depth"):
        assert name in text, name


def test_prefetching_iter_raises_the_producer_error():
    class Broken(mxt.io.DataIter):
        def __init__(self):
            super().__init__(2)
            self.n = 0

        def next(self):
            self.n += 1
            if self.n > 2:
                raise ValueError("bad record")
            return mxt.io.DataBatch([mxt.nd.zeros((2,), ctx=mxt.cpu())])

    it = mxt.io.PrefetchingIter(Broken())
    it.next()
    it.next()
    with pytest.raises(ValueError, match="bad record"):
        it.next()


def _producers():
    return [t for t in threading.enumerate() if t.name != "MainThread"
            and getattr(t, "_target", None) is not None
            and getattr(t._target, "__name__", "") == "_produce"]


def _settle(want):
    deadline = time.monotonic() + 5
    while len(_producers()) != want and time.monotonic() < deadline:
        time.sleep(0.02)
    return len(_producers())


def test_prefetching_iter_leaves_no_thread():
    gc.collect()                   # earlier iterators' producers stop
    before = _settle(0)
    it = mxt.io.PrefetchingIter(_base(mxt))
    list(it)                       # an epoch: the producer ends
    assert _settle(before) == before
    it.reset()                     # a new producer, one epoch ahead
    it.next()
    it.reset()                     # the old one joined
    assert _settle(before + 1) == before + 1
    del it                         # dropped: its producer stops
    gc.collect()
    assert _settle(before) == before
