"""KVStore: the key-value parameter store, in its single-process form.

Counterpart of `mxnet_tpu/kvstore.py` (reference `include/mxnet/kvstore.h`
and `python/mxnet/kvstore.py`) for the ``local``, ``device``, ``nccl``,
``tpu`` and ``local_allreduce_*`` types: ``init`` (once a key), ``push``
of one value or a list a key (int or string keys, not mixed), ``pull``,
``row_sparse_pull``, ``set_optimizer`` / ``_set_updater``, the optimizer's
state files, ``rank``, ``num_workers``, ``barrier`` and ``type``.

Pushed values of one key are summed onto the first one's device (a
pairwise tree, ``_ctx_group_sum``). A push whose values are all compact
row-sparse arrays is merged by ``sparse.add_rows`` and never made dense;
with an updater it takes the optimizer's lazy row update (one launch of
S1 a key on the card), and a dense list push with the standard
``Updater`` updates every key in one call of ``optimizer.FusedApplier``.
``row_sparse_pull`` moves only the requested rows: into a row-sparse
``out`` as its compact payload, into a dense one scattered over zeros.

The ``dist*`` types, ``AsyncKVStore`` and gradient compression are
distributed training, ROADMAP A.10, and raise ``MXNetError``. The JAX
package also folds every push and pull into its telemetry registry
(``_record_kv``); the port has no telemetry yet (ROADMAP A.9), so nothing
is recorded here.
"""
from __future__ import annotations

import torch

from . import optimizer as opt
from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["KVStore", "AsyncKVStore", "create"]

_LOCAL = ("local", "device", "nccl", "tpu", "local_allreduce_cpu",
          "local_allreduce_device")
_DIST = ("dist_sync", "dist_async", "dist_sync_device", "dist_device_sync",
         "dist")


def _not_ported(what):
    return MXNetError("%s is distributed training, which is not ported yet "
                      "(ROADMAP A.10); use a single-process kvstore such as "
                      "'local'" % what)


def _ctx_group_sum(vals):
    """Sum a list of NDArrays onto the first one's device with a pairwise
    tree (reference CommDevice's reduce, comm.h)."""
    vals = list(vals)
    while len(vals) > 1:
        nxt = [vals[i] + vals[i + 1].as_in_context(vals[i].context)
               for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]


def _normalize(key, value):
    if isinstance(key, (str, int)):
        return [key], [value]
    return list(key), list(value)


def _dense_copy(value):
    """A dense NDArray of its own with ``value``'s values."""
    if value.stype != "default":
        return value.todense()
    return NDArray(value.data.detach().clone(), value.context)


class KVStore:
    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._key_type = None
        self._fused = None      # FusedApplier over the updater, or False

    # -- identity ----------------------------------------------------------
    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def _check_key(self, key):
        kt = str if isinstance(key, str) else int
        if self._key_type is None:
            self._key_type = kt
        elif self._key_type is not kt:
            raise MXNetError("inconsistent key types")
        return key

    # -- core API ----------------------------------------------------------
    def init(self, key, value):
        """Store a copy of each key's (first) value; a key is initialized
        once."""
        keys, values = _normalize(key, value)
        for k, v in zip(keys, values):
            self._check_key(k)
            if k in self._store:
                raise MXNetError("key %s already initialized" % str(k))
            vlist = v if isinstance(v, list) else [v]
            self._store[k] = _dense_copy(vlist[0])

    def push(self, key, value, priority=0):
        """Sum each key's values; then run the updater on the stored value
        with the sum, or, without an updater, store the sum."""
        from .ndarray import sparse
        keys, values = _normalize(key, value)
        merged_list = []
        for k, vs in zip(keys, values):
            if k not in self._store:
                raise MXNetError("key %s not initialized" % str(k))
            vs = vs if isinstance(vs, list) else [vs]
            if all(opt._is_lazy_rowsparse(v) for v in vs):
                merged = vs[0]
                for v in vs[1:]:
                    merged = sparse.add_rows(merged, v)
            else:
                merged = _ctx_group_sum(vs)
            merged_list.append(merged)
        batch = []
        for k, merged in zip(keys, merged_list):
            stored = self._store[k]
            merged = merged.as_in_context(stored.context)
            if self._updater is not None:
                batch.append((k, merged, stored))
            else:
                merged.copyto(stored)
        if batch:
            self._apply_updates(batch)

    def _apply_updates(self, batch):
        """Run the updater over the pushed keys: a compact row-sparse
        gradient key by key (its lazy row update), a dense list push with
        the standard ``Updater`` in one ``FusedApplier`` call."""
        if any(opt._is_lazy_rowsparse(g) for _, g, _ in batch):
            for k, merged, stored in batch:
                self._updater(k, merged, stored)
            return
        if len(batch) > 1 and self._fused is not False:
            if self._fused is None:
                self._fused = opt.FusedApplier.resolve(self._updater) \
                    if isinstance(self._updater, opt.Updater) else False
            if self._fused:
                self._fused([k for k, _, _ in batch],
                            [w for _, _, w in batch],
                            [g for _, g, _ in batch])
                return
        for k, merged, stored in batch:
            self._updater(k, merged, stored)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's stored value into its ``out`` array(s)."""
        keys, outs = _normalize(key, out)
        for k, os_ in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("key %s not initialized" % str(k))
            for o in (os_ if isinstance(os_, list) else [os_]):
                self._store[k].copyto(o)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` (reference kvstore.h
        PullRowSparse), sorted and deduplicated as ``np.unique`` does: a
        row-sparse ``out`` receives them as its compact payload, a dense
        ``out`` gets them scattered over zeros."""
        if row_ids is None:
            return self.pull(key, out, priority)
        from .ndarray import sparse
        keys, outs = _normalize(key, out)
        rids = row_ids if isinstance(row_ids, list) else [row_ids]
        for k, os_ in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("key %s not initialized" % str(k))
            src = self._store[k].data
            os_ = os_ if isinstance(os_, list) else [os_]
            for o, rid in zip(os_, rids * len(os_)):
                ids = torch.unique(sparse._row_ids(rid, src.device),
                                   sorted=True)
                rows = src.index_select(0, ids)
                if isinstance(o, sparse.RowSparseNDArray):
                    dev = o._device()
                    o._set_compact({"values": rows.to(dev, o._dtype),
                                    "indices": ids.to(dev)})
                    continue
                t = o._data
                with torch.no_grad():
                    t.zero_()
                    t.index_copy_(0, ids.to(t.device),
                                  rows.to(t.device, t.dtype))
                o._wrote()

    # -- optimizer / updater -----------------------------------------------
    def set_optimizer(self, optimizer):
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self._fused = None

    def _set_updater(self, updater):
        self._updater = updater
        self._fused = None

    def set_gradient_compression(self, compression_params):
        raise _not_ported("gradient compression")

    def barrier(self):
        """Nothing to wait for in one process."""

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("Cannot save states for distributed training")
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("Cannot load states for distributed training")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())
        self._fused = None


class AsyncKVStore(KVStore):
    """``dist_async``: a parameter server, not ported yet (ROADMAP A.10)."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("kvstore 'dist_async'")


def create(name="local"):
    """A KVStore of type ``name`` (reference `src/kvstore/kvstore.cc`)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in _DIST:
        raise _not_ported("kvstore %r" % name)
    if name not in _LOCAL:
        raise MXNetError("unknown kvstore type %s" % name)
    return KVStore(name)
