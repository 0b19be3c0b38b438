"""Vision datasets and transforms (counterpart of
`mxnet_tpu/gluon/data/vision.py`, reference
`python/mxnet/gluon/data/vision/`).

``MNIST``, ``FashionMNIST``, ``CIFAR10`` and ``CIFAR100`` read the
standard files from ``root`` (idx-ubyte, raw or ``.gz``; CIFAR's binary
batches, in the directory the tar files unpack to or directly under
``root``, or the ``.tar.gz`` archive itself); nothing is downloaded, and a
missing file raises. Images are uint8 NDArrays in HWC order on the host,
labels int32, as in the JAX package. ``transforms`` holds ``Compose``,
``ToTensor``, ``Normalize``, ``Cast`` and ``RandomFlipLeftRight``.
``ImageRecordDataset``, ``ImageFolderDataset`` and the ``Resize``,
``CenterCrop`` and ``RandomResizedCrop`` transforms decode or resize
images through the ``image`` module, which the port has not yet (ROADMAP
A.11): they raise.
"""
from __future__ import annotations

import gzip
import os
import random as pyrandom
import struct
import tarfile

import numpy as np

from ...base import MXNetError
from ...context import cpu
from ...ndarray.ndarray import array
from ..block import Block
from .dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset", "transforms"]


def _needs_image(what):
    return MXNetError("%s decodes or resizes images through the image "
                      "module, which the port does not have yet (ROADMAP "
                      "A.11)" % what)


class _DownloadedDataset(Dataset):
    """A dataset read from local files under ``root`` at construction."""

    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        os.makedirs(self._root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def _read_idx_file(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        ndim = struct.unpack(">I", f.read(4))[0] & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


class MNIST(_DownloadedDataset):
    _files = {True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
              False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        paths = [os.path.join(self._root, name)
                 for name in self._files[self._train]]
        for p in paths:
            if not (os.path.exists(p) or os.path.exists(p + ".gz")):
                raise MXNetError("%s file %s not found (nothing is "
                                 "downloaded; place the idx-ubyte files "
                                 "under %s)" % (type(self).__name__, p,
                                                self._root))
        if not os.path.exists(paths[0]):
            paths = [p + ".gz" for p in paths]
        data, label = (_read_idx_file(p) for p in paths)
        self._data = array(data.reshape(-1, 28, 28, 1), ctx=cpu(),
                           dtype=np.uint8)
        self._label = label.astype(np.int32)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    _record = 3072 + 1          # label byte, then 3x32x32 CHW
    _subdir = "cifar-10-batches-bin"
    _archive = "cifar-10-binary.tar.gz"

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _files(self):
        if self._train:
            return ["data_batch_%d.bin" % i for i in range(1, 6)]
        return ["test_batch.bin"]

    def _label_of(self, rows):
        return rows[:, 0]

    def _read_batch(self, raw):
        rows = np.frombuffer(raw, dtype=np.uint8).reshape(-1, self._record)
        images = rows[:, self._record - 3072:].reshape(-1, 3, 32, 32)
        return images.transpose(0, 2, 3, 1), \
            self._label_of(rows).astype(np.int32)

    def _raw_batches(self):
        sub = os.path.join(self._root, self._subdir)
        base = sub if os.path.isdir(sub) else self._root
        paths = [os.path.join(base, f) for f in self._files()]
        if all(os.path.exists(p) for p in paths):
            for p in paths:
                with open(p, "rb") as f:
                    yield f.read()
            return
        archive = os.path.join(self._root, self._archive)
        if not os.path.exists(archive):
            missing = next(p for p in paths if not os.path.exists(p))
            raise MXNetError("%s file %s not found, nor %s (nothing is "
                             "downloaded; place the binary batches under "
                             "%s)" % (type(self).__name__, missing, archive,
                                      self._root))
        with tarfile.open(archive) as tar:
            members = {os.path.basename(m.name): m for m in tar.getmembers()}
            for name in self._files():
                if name not in members:
                    raise MXNetError("%s has no %s" % (archive, name))
                yield tar.extractfile(members[name]).read()

    def _get_data(self):
        data, label = zip(*(self._read_batch(raw)
                            for raw in self._raw_batches()))
        self._data = array(np.concatenate(data), ctx=cpu(), dtype=np.uint8)
        self._label = np.concatenate(label)


class CIFAR100(CIFAR10):
    _record = 3072 + 2          # coarse label byte, fine label byte, image
    _subdir = "cifar-100-binary"
    _archive = "cifar-100-binary.tar.gz"

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _files(self):
        return ["train.bin"] if self._train else ["test.bin"]

    def _label_of(self, rows):
        return rows[:, int(bool(self._fine_label))]


class ImageRecordDataset(Dataset):
    """Images in a RecordIO file: waits for ``image`` and ``recordio``
    (ROADMAP A.11)."""

    def __init__(self, filename, flag=1, transform=None):
        raise _needs_image("ImageRecordDataset(%s)" % filename)


class ImageFolderDataset(Dataset):
    """Images in class folders: waits for ``image`` (ROADMAP A.11)."""

    def __init__(self, root, flag=1, transform=None):
        raise _needs_image("ImageFolderDataset(%s)" % root)


class transforms:
    """Reference ``gluon/data/vision/transforms.py`` as a namespace."""

    class Compose(Block):
        """Apply each transform in turn."""

        def __init__(self, transforms_list):
            super().__init__()
            self._transforms = transforms_list

        def forward(self, x):
            for t in self._transforms:
                x = t(x)
            return x

    class ToTensor(Block):
        """HWC (or NHWC) uint8 in [0, 255] -> CHW (NCHW) f32 in [0, 1]."""

        def forward(self, x):
            out = x.astype(np.float32) / 255.0
            if out.ndim == 3:
                return out.transpose((2, 0, 1))
            return out.transpose((0, 3, 1, 2))

    class Normalize(Block):
        """``(x - mean) / std`` per channel of a CHW image."""

        def __init__(self, mean, std):
            super().__init__()
            self._mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
            self._std = np.asarray(std, np.float32).reshape(-1, 1, 1)

        def forward(self, x):
            return (x - array(self._mean, ctx=x.context)) \
                / array(self._std, ctx=x.context)

    class Cast(Block):
        def __init__(self, dtype="float32"):
            super().__init__()
            self._dtype = dtype

        def forward(self, x):
            return x.astype(self._dtype)

    class Resize(Block):
        """Waits for ``image.imresize`` (ROADMAP A.11)."""

        def __init__(self, size, keep_ratio=False, interpolation=1):
            raise _needs_image("transforms.Resize")

    class CenterCrop(Block):
        """Waits for ``image.center_crop`` (ROADMAP A.11)."""

        def __init__(self, size, interpolation=1):
            raise _needs_image("transforms.CenterCrop")

    class RandomResizedCrop(Block):
        """Waits for ``image.fixed_crop`` (ROADMAP A.11)."""

        def __init__(self, size, scale=(0.08, 1.0),
                     ratio=(3.0 / 4.0, 4.0 / 3.0), interpolation=1):
            raise _needs_image("transforms.RandomResizedCrop")

    class RandomFlipLeftRight(Block):
        """Flip an HWC image left to right with probability 1/2 (Python's
        ``random``, as in the JAX package)."""

        def forward(self, x):
            if pyrandom.random() < 0.5:
                return x.flip(axis=1)
            return x
