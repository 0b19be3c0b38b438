"""``gluon.data.vision`` of the port against the JAX package's, on the
CPU.

The test writes MNIST and Fashion-MNIST idx-ubyte files (raw and
``.gz``) and CIFAR-10 and CIFAR-100 binary batches (in the directory the
archives unpack to, and directly under ``root``) from a numpy seed. Both
packages read the same samples: images (uint8, HWC) and labels are
equal, and so is every item after ``transforms.Compose([Cast,
ToTensor, Normalize])`` (rtol 1e-6: the same f32 arithmetic), and with
``RandomFlipLeftRight`` under one Python seed. A ``DataLoader`` over a
port dataset yields numpy's batches. The port also reads CIFAR's
``.tar.gz`` archive itself. Nothing is downloaded: a missing file raises
in both packages. The five names that need the ``image`` module
(``ImageRecordDataset``, ``ImageFolderDataset``, ``Resize``,
``CenterCrop``, ``RandomResizedCrop``) raise, naming ROADMAP A.11.
"""
import gzip
import os
import random
import struct
import tarfile

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu.gluon.data import vision as jvision
from mxnet_tpu_torch.gluon.data import vision as tvision

CPU = mxt.cpu()
MEAN, STD = (0.4914, 0.4822, 0.4465), (0.247, 0.243, 0.261)


def _write_idx(path, arr, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def _mnist_root(tmp_path, n, gz, seed=0):
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, n).astype(np.uint8)
    root = tmp_path / ("mnist_gz" if gz else "mnist")
    root.mkdir()
    for train in (True, False):
        img_name, lbl_name = tvision.MNIST._files[train]
        suffix = ".gz" if gz else ""
        _write_idx(str(root / (img_name + suffix)), images, gz)
        _write_idx(str(root / (lbl_name + suffix)), labels, gz)
    return str(root), images, labels


def _cifar_rows(rs, n, n_labels, n_classes):
    labels = rs.randint(0, n_classes, (n, n_labels)).astype(np.uint8)
    images = rs.randint(0, 256, (n, 3, 32, 32)).astype(np.uint8)
    return np.concatenate([labels, images.reshape(n, -1)], axis=1), \
        images, labels


def _cifar10_root(tmp_path, sub, seed=1, n=6):
    rs = np.random.RandomState(seed)
    root = tmp_path / ("c10_sub" if sub else "c10")
    base = root / "cifar-10-batches-bin" if sub else root
    base.mkdir(parents=True)
    want = {}
    for train, names in ((True, ["data_batch_%d.bin" % i
                                 for i in range(1, 6)]),
                         (False, ["test_batch.bin"])):
        parts = []
        for name in names:
            rows, images, labels = _cifar_rows(rs, n, 1, 10)
            (base / name).write_bytes(rows.tobytes())
            parts.append((images, labels))
        want[train] = (np.concatenate([p[0] for p in parts])
                       .transpose(0, 2, 3, 1),
                       np.concatenate([p[1][:, 0] for p in parts]))
    return str(root), want


def _cifar100_root(tmp_path, seed=2, n=8):
    rs = np.random.RandomState(seed)
    root = tmp_path / "c100"
    base = root / "cifar-100-binary"
    base.mkdir(parents=True)
    want = {}
    for train, name in ((True, "train.bin"), (False, "test.bin")):
        rows, images, labels = _cifar_rows(rs, n, 2, 100)
        (base / name).write_bytes(rows.tobytes())
        want[train] = (images.transpose(0, 2, 3, 1), labels)
    return str(root), want


def _items(ds, pkg):
    out = []
    for i in range(len(ds)):
        img, label = ds[i]
        out.append((np.asarray(img.asnumpy()), int(label)))
    return out


def _same_items(got, want):
    assert len(got) == len(want) > 0
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype
        np.testing.assert_array_equal(gi, wi)
        assert gl == wl


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
def test_mnist_family_reads_the_same_samples(tmp_path, cls, train, gz):
    root, images, labels = _mnist_root(tmp_path, 7, gz)
    got = getattr(tvision, cls)(root=root, train=train)
    with mx.cpu():
        want = getattr(jvision, cls)(root=root, train=train)
        want_items = _items(want, mx)
    got_items = _items(got, mxt)
    _same_items(got_items, want_items)
    np.testing.assert_array_equal(np.stack([i for i, _ in got_items]),
                                  images[..., None])
    assert [lb for _, lb in got_items] == labels.tolist()
    assert got[0][0].context == CPU


@pytest.mark.parametrize("sub", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_cifar10_reads_the_same_samples(tmp_path, train, sub):
    root, want_np = _cifar10_root(tmp_path, sub)
    got = _items(tvision.CIFAR10(root=root, train=train), mxt)
    with mx.cpu():
        want = _items(jvision.CIFAR10(root=root, train=train), mx)
    _same_items(got, want)
    images, labels = want_np[train]
    np.testing.assert_array_equal(np.stack([i for i, _ in got]), images)
    assert [lb for _, lb in got] == labels.tolist()


@pytest.mark.parametrize("fine", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_cifar100_reads_the_same_samples(tmp_path, train, fine):
    root, want_np = _cifar100_root(tmp_path)
    got = _items(tvision.CIFAR100(root=root, train=train,
                                  fine_label=fine), mxt)
    with mx.cpu():
        want = _items(jvision.CIFAR100(root=root, train=train,
                                       fine_label=fine), mx)
    _same_items(got, want)
    assert [lb for _, lb in got] == want_np[train][1][:, int(fine)].tolist()


def test_cifar10_reads_its_archive(tmp_path):
    root, want_np = _cifar10_root(tmp_path, True)
    archive = tmp_path / "archive"
    archive.mkdir()
    with tarfile.open(str(archive / "cifar-10-binary.tar.gz"), "w:gz") as tar:
        tar.add(os.path.join(root, "cifar-10-batches-bin"),
                arcname="cifar-10-batches-bin")
    got = _items(tvision.CIFAR10(root=str(archive), train=False), mxt)
    np.testing.assert_array_equal(np.stack([i for i, _ in got]),
                                  want_np[False][0])


def _pipeline(pkg, flip):
    t = pkg.gluon.data.vision.transforms
    steps = [t.Cast("float32"), t.ToTensor(), t.Normalize(MEAN, STD)]
    if flip:
        steps.insert(0, t.RandomFlipLeftRight())
    return t.Compose(steps)


@pytest.mark.parametrize("flip", [False, True])
def test_transforms_match(tmp_path, flip):
    root, _ = _cifar10_root(tmp_path, False)
    got, want = [], []
    random.seed(11)
    ds = tvision.CIFAR10(root=root, train=False)
    tf = _pipeline(mxt, flip)
    for i in range(len(ds)):
        got.append(tf(ds[i][0]).asnumpy())
    random.seed(11)
    with mx.cpu():
        jds = jvision.CIFAR10(root=root, train=False)
        jtf = _pipeline(mx, flip)
        for i in range(len(jds)):
            want.append(jtf(jds[i][0]).asnumpy())
    for g, w in zip(got, want):
        assert g.shape == (3, 32, 32)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    if flip:
        random.seed(11)
        flips = [random.random() < 0.5 for _ in range(len(ds))]
        assert 0 < sum(flips) < len(ds)


def test_to_tensor_on_a_batch_and_dataset_transform(tmp_path):
    root, images, labels = _mnist_root(tmp_path, 5, False)
    tf = tvision.transforms.ToTensor()
    ds = tvision.MNIST(root=root, transform=lambda x, y: (tf(x), y + 1))
    img, label = ds[2]
    np.testing.assert_allclose(img.asnumpy(),
                               images[2][None].astype(np.float32) / 255.0,
                               rtol=1e-7)
    assert label == labels[2] + 1
    batch = mxt.nd.array(images[:, :, :, None], ctx=CPU, dtype=np.uint8)
    assert tf(batch).shape == (5, 1, 28, 28)


def test_data_loader_batches_equal_numpy(tmp_path):
    root, images, labels = _mnist_root(tmp_path, 10, True)
    ds = tvision.MNIST(root=root)
    loader = mxt.gluon.data.DataLoader(ds, batch_size=4, last_batch="keep")
    got = [(x.asnumpy(), y.asnumpy()) for x, y in loader]
    assert [x.shape[0] for x, _ in got] == [4, 4, 2]
    np.testing.assert_array_equal(np.concatenate([x for x, _ in got]),
                                  images[..., None])
    np.testing.assert_array_equal(np.concatenate([y for _, y in got]),
                                  labels)


def test_a_missing_file_raises_and_nothing_is_downloaded(tmp_path):
    empty = str(tmp_path / "nothing")
    for cls in ("MNIST", "FashionMNIST", "CIFAR10", "CIFAR100"):
        with pytest.raises(mxt.MXNetError, match="not found"):
            getattr(tvision, cls)(root=empty)
        with pytest.raises(mx.MXNetError, match="not found"):
            getattr(jvision, cls)(root=empty)


@pytest.mark.parametrize("make", [
    lambda: tvision.ImageRecordDataset("x.rec"),
    lambda: tvision.ImageFolderDataset("folder"),
    lambda: tvision.transforms.Resize(32),
    lambda: tvision.transforms.CenterCrop(32),
    lambda: tvision.transforms.RandomResizedCrop(32)])
def test_image_module_names_raise_naming_a11(make):
    with pytest.raises(mxt.MXNetError, match="A.11"):
        make()
