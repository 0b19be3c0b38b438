"""Gluon utilities.

Counterpart of `mxnet_tpu/gluon/utils.py` (reference
`python/mxnet/gluon/utils.py`): ``split_data``, ``split_and_load``,
``clip_global_norm``, ``check_sha1`` and ``download``. ``split_and_load``
gives one slice per context, in the reference's way (the JAX package's
default for several devices, one array sharded over a mesh, is not
ported: ``sharded=True`` raises). ``download`` reads only files that are
already on disk: the port fetches nothing from the network.
"""
from __future__ import annotations

import hashlib
import os
import warnings

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` views of ``data`` along ``batch_axis``; the last
    takes the remainder when ``even_split`` is False."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError(
            "Too many slices for data with shape %s. Arguments are "
            "num_slice=%d and batch_axis=%d." % (str(data.shape), num_slice,
                                                 batch_axis))
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data." % (
                str(data.shape), num_slice, batch_axis, num_slice))
    step = size // num_slice
    lead = (slice(None),) * batch_axis
    return [data[lead + (slice(i * step, (i + 1) * step if i < num_slice - 1
                               else size),)]
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True,
                   sharded=None):
    """Split ``data`` (an NDArray or anything ``nd.array`` takes) into one
    slice per context of ``ctx_list`` and copy each onto its context."""
    if sharded:
        raise MXNetError("split_and_load(sharded=True): one array sharded "
                         "over several devices is not ported; the port "
                         "gives one slice per context")
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Scale ``arrays`` in place so that the 2-norm of all of them
    together is at most ``max_norm``; returns that norm before scaling.
    A norm that is not finite is warned about, counted in
    ``grad_nonfinite_total`` and booked as runprof's
    ``nonfinite_grad_norm`` anomaly, and leaves the arrays as they are."""
    if not arrays:
        raise MXNetError("clip_global_norm needs at least one array")
    total = 0.0
    with torch.no_grad():
        for arr in arrays:
            x = arr.data.reshape(-1)
            total += float(torch.dot(x, x))
    total_norm = float(np.sqrt(total))
    if not np.isfinite(total_norm):
        warnings.warn(UserWarning("nan or inf is detected. Clipping "
                                  "results will be undefined."),
                      stacklevel=2)
        # divergence must be countable, not just printable: the counter
        # survives scrollback and the sentinel dumps the flight recorder
        # (MXNET_RUNPROF_HALT=1 also stops the run)
        from .. import runprof, telemetry
        telemetry.counter(
            "grad_nonfinite_total",
            help="non-finite global gradient norms observed by "
                 "clip_global_norm").inc()
        runprof.note_anomaly("nonfinite_grad_norm",
                             detail="clip_global_norm over %d arrays"
                                    % len(arrays),
                             value=float(total_norm))
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr *= scale
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 digest is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    """The local copy of ``url``'s file (at ``path``, a directory holding
    it, or the file's name), when it exists and matches ``sha1_hash``;
    otherwise raise: nothing is fetched."""
    fname = url.split("/")[-1]
    if path is None:
        path = fname
    elif os.path.isdir(path):
        path = os.path.join(path, fname)
    if os.path.exists(path) and not overwrite and \
            (not sha1_hash or check_sha1(path, sha1_hash)):
        return path
    raise MXNetError("download(%s): the port fetches nothing from the "
                     "network; place the file at %s" % (url, path))
