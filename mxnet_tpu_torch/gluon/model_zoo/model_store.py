"""Where pretrained zoo weights come from (counterpart of
`mxnet_tpu/gluon/model_zoo/model_store.py`, reference
`python/mxnet/gluon/model_zoo/model_store.py`).

Nothing is downloaded: a model's weights are the file ``<name>.params`` or
``<name>-0000.params`` under ``root`` (default ``~/.mxnet/models``), else
under ``$MXNET_TPU_MODEL_DIR``, in the ``.params`` format either package
writes (``Block.save_parameters``, or `tools/convert_zoo_params.py` from a
reference MXNet zoo file). Without such a file ``get_model_file`` raises.
"""
from __future__ import annotations

import os

from ...base import MXNetError

__all__ = ["get_model_file", "purge"]


def _root(root):
    return os.path.expanduser(root or os.path.join("~", ".mxnet", "models"))


def get_model_file(name, root=None):
    """The path of model ``name``'s weights file under ``root``, else
    under ``$MXNET_TPU_MODEL_DIR``; raises when neither holds one."""
    root = _root(root)
    for where in (root, os.environ.get("MXNET_TPU_MODEL_DIR", "")):
        if not where:
            continue
        for fname in ("%s.params" % name, "%s-0000.params" % name):
            path = os.path.join(where, fname)
            if os.path.exists(path):
                return path
    raise MXNetError(
        "no pretrained weights file for %s under %s or $MXNET_TPU_MODEL_DIR, "
        "and nothing is downloaded: place %s.params there (for example "
        "converted by mxnet_tpu_torch/tools/convert_zoo_params.py)"
        % (name, root, name))


def purge(root=None):
    """Delete every ``.params`` file under ``root``."""
    root = _root(root)
    if os.path.isdir(root):
        for f in os.listdir(root):
            if f.endswith(".params"):
                os.remove(os.path.join(root, f))
