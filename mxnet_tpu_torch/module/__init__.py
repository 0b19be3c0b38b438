"""`mx.mod` namespace of the port (reference `python/mxnet/module/`)."""
from .base_module import BaseModule, BatchEndParam
from .module import Module

__all__ = ["BaseModule", "BatchEndParam", "Module"]
