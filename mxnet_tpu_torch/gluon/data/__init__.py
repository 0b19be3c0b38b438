"""The Gluon data API (reference `python/mxnet/gluon/data/`): datasets,
samplers, the ``DataLoader`` and ``vision`` (the MNIST and CIFAR datasets
from local files, and the transforms)."""
from .dataset import Dataset, SimpleDataset, ArrayDataset, RecordFileDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler
from .dataloader import DataLoader
from . import vision

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader", "vision"]
