"""mxnet_tpu_torch: the PyTorch/CUDA port of `mxnet_tpu`.

A second package beside the JAX one, with the same module names, so an
``import mxnet_tpu_torch as mx`` script reads like one written against
`mxnet_tpu`. It imports neither JAX nor `mxnet_tpu`. It holds seven paths
so far:

- serving: ``sym`` -> ``Executor`` -> ``Predictor`` ->
  ``serving.InferenceEngine`` -> HTTP, with the LSTM layer on a
  hand-written CUDA inference kernel (`csrc/fused_lstm.cu`, the
  persistent recurrence of `csrc/lstm_persistent.cuh`);
- LM training: ``sym`` -> ``mod.Module`` (bind, ``init_params``,
  ``init_optimizer``, ``fit``/``_step``/``_step_scan``, ``score``) with
  ``io``, ``metric``, ``optimizer``, ``initializer`` and ``callback``,
  the LSTM layer on hand-written CUDA training kernels
  (`csrc/fused_lstm_train.cu`; `ops/lstm_kernel.py` binds all three);
- image-classifier training: a ``gluon.model_zoo.vision`` ResNet built
  and run eagerly through ``nd``, traced to a Symbol
  (``HybridBlock._trace_symbol``) and trained by ``mod.Module``, with
  ``Convolution``, ``BatchNorm``, ``Pooling`` and ``Activation``; with
  ``MXNET_CONV1X1_PALLAS`` on, the input gradient of every NHWC
  stride-2 1x1 convolution is a hand-written CUDA kernel
  (`csrc/conv1x1_s2_dgrad.cu`, bound by `ops/conv_kernel.py`);
- attention: ``nd.contrib.flash_attention`` and
  ``sym.contrib.flash_attention`` (``_contrib_flash_attention``), whose
  forward is a hand-written CUDA kernel (`csrc/flash_attention.cu`, bound
  by `ops/attention_kernel.py`), in graphs trained by ``mod.Module``
  with ``LayerNorm``;
- image-classifier inference: a ``gluon.model_zoo.vision`` ResNet after
  ``hybridize()`` runs as one `compiled.CompiledProgram`: on the card one
  captured CUDA graph per input signature (the parameters read in place,
  the inputs copied into static buffers, the outputs cloned), replayed
  with one launch a call; on ``cpu()`` the same signature cache and
  ``compiled.compile_counts()`` over an eager run. ``nd.random`` draws
  the inputs (`ops/random_ops.py`, seeded by ``random.seed``), and
  `tools/bench.py` is the port's counterpart of the repository's
  ``bench.py`` (run it on a GPU host as ``python3
  mxnet_tpu_torch/tools/bench.py``);
- Gluon training: ``autograd.record()`` over a ``gluon`` net (eager or
  hybridized), ``loss.backward()`` and ``gluon.Trainer.step`` with the
  losses of ``gluon.loss``; the tape is ``torch.autograd``
  (`autograd.py`), a parameter's tensor a leaf whose gradient lands in
  its ``.grad`` buffer, and with ``MXNET_CONV1X1_PALLAS`` on the NHWC
  stride-2 1x1 convolutions take their input gradient from the same
  hand-written kernel as in ``Module`` training; ``gluon.data`` and
  ``gluon.utils`` feed it;
- sparse training: ``nd.sparse`` (row-sparse and CSR arrays over their
  compact payload, ``dot`` on it under the tape), ``kv`` (the local
  ``KVStore`` with ``row_sparse_pull``) and the optimizers' lazy
  row-sparse updates, one launch of a hand-written CUDA kernel a push
  (`csrc/sparse_row_update.cu`, bound by `ops/sparse_update.py`).

``rtc`` compiles and launches user CUDA kernels at runtime (NVRTC and
``libcuda``), the reference's ``mx.rtc.CudaModule``.

Entry points run on ``gpu(0)`` (``cuda:0``) unless the caller passes
``cpu()``; without a CUDA device they raise rather than fall back.
``tpu(i)``, the JAX package's accelerator context, is ``cuda:i`` too.
``python -m mxnet_tpu_torch.tools.run_example`` runs an example written
for the JAX package with its ``mxnet_tpu`` imports rewritten.
"""
from .base import MXNetError
from .context import (Context, cpu, gpu, tpu, cpu_pinned, current_context,
                      num_gpus, num_tpus)
from . import context
from . import random
from . import autograd
from . import ndarray
from . import ndarray as nd
from . import ops
from . import symbol
from . import symbol as sym
from .executor import Executor
from . import initializer
from . import initializer as init
from . import optimizer
from . import kvstore
from . import kvstore as kv
from .kvstore import create as kvstore_create
from . import lr_scheduler
from . import misc
from . import io
from . import metric
from . import module
from . import module as mod
from . import model
from . import callback
from . import name
from . import gluon
from . import compiled
from .predict import Predictor
from .weights import (params_from_numpy, params_to_numpy,
                      set_block_params)
from . import serving
from . import rtc
from . import operator

__all__ = ["MXNetError", "Context", "cpu", "gpu", "tpu", "cpu_pinned",
           "current_context", "num_gpus", "num_tpus", "context", "random",
           "nd", "ndarray", "ops", "sym", "symbol",
           "Executor", "init", "initializer", "optimizer", "kv", "kvstore",
           "kvstore_create", "lr_scheduler",
           "misc", "io", "metric",
           "mod", "module", "model", "callback", "name", "gluon", "compiled",
           "autograd", "Predictor", "params_from_numpy", "params_to_numpy",
           "set_block_params", "serving", "rtc", "operator"]
