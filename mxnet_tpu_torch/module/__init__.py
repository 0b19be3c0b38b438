"""`mx.mod` namespace of the port (reference `python/mxnet/module/`)."""
from .base_module import BaseModule, BatchEndParam
from .module import Module
from .bucketing_module import BucketingModule

__all__ = ["BaseModule", "BatchEndParam", "Module", "BucketingModule"]
