#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository on a host with a CUDA device::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``mxnet_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, then serves the
2x650 PTB LSTM language model (vocab 10000, embed 650, 2 LSTM layers of
650, 35 steps, fp32; the configuration of
``examples/rnn/word_lm/benchmark.py``) with seeded random weights
through the port's user entry points, in six phases:

1. build the kernels (one ``nvcc`` per source, all at once);
2. ``fused_lstm`` kernel vs plain version at the served shapes
   (T=35, B in {1, 8, 32}, I=H=650), at B = 3 and 64, at T = 1, at a
   shape that takes the step route and at a ragged small shape, with
   kernel, plain and cuDNN (``torch.nn.LSTM``, timed as a yardstick only)
   times and the kernel's bound at the served shapes; each call's route
   against its plan (grid, units a block, rows, shared memory; every
   shape at H=650 persistent), the recurrence kernel's launches a call
   (1 on the persistent route) and device µs a step from a profile,
   ptxas's registers and spills, and 20 calls at B=32 bit-identical;
3. ``Predictor`` on ``gpu(0)`` vs the same ``Predictor`` on ``cpu()``;
4. ``InferenceEngine`` on ``gpu(0)`` (buckets 1..32) under 100 concurrent
   requests of 1-8 rows, sampled results held against the CPU reference;
5. the HTTP server in-process: two ``/predict`` requests, ``/healthz``,
   ``/shutdown``;
6. ``torch.profiler`` over one served forward at the top bucket: device
   time by kernel, K1's share and launches (one persistent launch a
   layer) and the device's idle share;

and then trains the same LM, the configuration of the training benchmark
(``examples/rnn/word_lm/benchmark.py``: batch 32, SGD with lr 1 and
``clip_gradient`` 0.25, Xavier init), in three more:

7. the training kernels ``fused_lstm_train`` (K2) and
   ``lstm_bwd_recurrence`` (K3) vs their plain versions, and a
   ``FusedLSTM`` layer's six gradients vs the plain backward, at T=35,
   B in {8, 32}, I=H=650 and a ragged shape, with kernel, plain and cuDNN
   (forward, backward, both; timed as a yardstick only) times; K2 and K3
   at phase 2's extra shapes and the step route's, their routes against
   their plans, the recurrence kernels' launches a call (one each on the
   persistent routes) and µs a step, ptxas reports and 20 bit-identical
   calls at B=32, as phase 2 for K1;
8. ``Module`` on ``gpu(0)`` from ``mx.random.seed(0)``: 2 ``_step``s held
   against the same Module on ``cpu()``, 20 timed steps of
   ``_step_scan`` after 2 warm-up steps (tokens/s trained) between two
   halves of 20 timed per-batch ``_step``s (the path ``fit`` takes by
   default, each batch copied from host memory), ``fit`` for
   one short epoch of an ``NDArrayIter`` with ``Perplexity`` and
   ``Speedometer``, and ``score`` on an eval iterator (K1);
9. ``torch.profiler`` over one train step: K2's and K3's shares and
   launches (each one persistent launch a layer);

and then trains ResNet-50 v1 at the configuration of the image
benchmark (``tools/bench_all.py:91-97``: NHWC, bf16, batch 128, 1000
classes, 224x224x3, SGD with lr 0.05 and momentum 0.9, Xavier init)
through the port's Gluon -> ``_trace_symbol`` -> ``Module`` path
(``examples/image-classification/benchmark.py:32-62``), full width and
depth, with ``MXNET_CONV1X1_PALLAS`` on, in three more:

10. ``conv1x1_s2_dgrad`` (K5) vs its plain version at the six stride-2
    1x1 shapes of the train step, bf16 and f32 (TF32 off), a ragged shape
    and a bf16 shape that takes the WMMA route, each call's route against
    its plan (the six bf16 sites on the wgmma route), with kernel, plain
    and cuDNN dgrad times and the bound, 20 bit-identical calls at stage
    2's downsample, and the wgmma kernels' ptxas registers, spills and
    shared memory;
11. the ResNet-50 Module: 2 f32 steps at batch 4 and lr 0.05 on
    ``gpu(0)`` held against the same Module on ``cpu()`` (outputs, moving
    statistics, every parameter's gradient and update) with two controls
    that must fail; at bf16 batch 128, forwards of the bf16 Module
    against an f32 Module from the same weights on 3 batches, with two
    controls that must fail, 2 warm-up ``_step``s, 10 timed ``_step``s
    and one ``_step_scan`` over 10 staged batches (img/s); 10 ``_step``s
    with the gate off (cuDNN's dgrad);
12. ``torch.profiler`` over one bf16 batch-128 step: device time by
    kernel class (cuDNN convolution forward, dgrad and wgrad, K5, GEMMs,
    BatchNorm, pooling and activation, optimizer, copies) and the idle
    share;

and then trains a causal attention LM through ``sym.contrib.
flash_attention`` (the block structure of
``examples/long-context/train_long_lm.py``, vocab 256, at the widths of
``tools/perf/attention_bench.py``: 8 heads of 128, E=1024, 2 layers,
B=1) and drives ``rtc``, in four more:

13. ``flash_attention`` (K4) vs its plain version at the bench's shapes
    (bf16, causal, T = 4096, 16384, 32768; at the two long ones on the
    last 256 query rows of every head), non-causal and f32 at T=4096 and
    ragged shapes with Tq != Tk both ways, with kernel, plain and
    ``scaled_dot_product_attention`` times (the yardstick only), TFLOP/s
    as the bench counts them and their share of the dtype's peak, and the
    bound; and the bf16 kernels' ptxas registers and spills and their
    shared memory a block;
14. the op's entry points on ``gpu(0)``: ``nd.contrib.flash_attention``,
    and ``sym.contrib.flash_attention`` bound by ``simple_bind`` with a
    forward and backward, the gradients held against the dense version's
    autograd;
15. the attention LM's ``Module``: 2 f32 SGD-momentum steps at T=512 on
    ``gpu(0)`` held against the same Module on ``cpu()`` (outputs, every
    parameter's gradient and update) with two controls that must fail;
    2 warm-up and 10 timed bf16 ``_step``s at T=4096 (tokens/s, the loss
    must fall), and ``torch.profiler`` over one of them;
16. ``rtc.CudaModule``: an ``extern "C"`` axpy and a templated row sum
    found through ``exports``, launched on ``gpu(0)`` and held against
    ``2*x + y`` (exactly) and ``x.sum(1)``; axpy at 2^26 timed against
    its bound, ``2*x + y`` and ``torch.add``;

and then runs ResNet-50 v1 inference at batch 32, f32, 224x224, full
width and depth, through ``hybridize`` (one captured CUDA graph per
input signature, `mxnet_tpu_torch/compiled.py`), by the steps of the
JAX bench (``bench.py:123-146``), in two more:

17. ``nd.random`` on ``gpu(0)``: every sampler's draws on the card, their
    moments at ``tests/test_random.py``'s tolerances, one seed
    reproducing a draw bit for bit and two draws without a reseed
    differing;
18. for NCHW and NHWC, TF32 off: the hybridized logits against the eager
    ones on the card and against the eager net on ``cpu()`` (batch 4)
    from the same weights, by relative norm to INFER_REL, with a control
    that must fail it (one BatchNorm's moving variance doubled);
    ``compile_counts()`` (one compile, then only cache hits, one retrace
    at batch 16 naming the batch dimension); ``warmup()`` leaving every
    moving statistic bit-identical and one train-mode call stepping them
    once, as the eager call does; a capture holding ``.asnumpy()``
    raising ``MXNetError``; ``torch.profiler`` over one hybridized and
    one eager call, cuDNN's TF32 off and on (device busy ms, idle share,
    the longest kernels, the host's launch calls: one
    ``cudaGraphLaunch`` and no kernel launch for the hybridized call;
    turning TF32 on is one retrace, and that graph's logits are held
    against the TF32-on eager ones to INFER_REL); peak memory; the
    operations bound
    from the layer shapes; and img/s hybridized and eager through the
    port's bench function (`mxnet_tpu_torch/tools/bench.py`), cuDNN's
    TF32 on and off;

and then trains ResNet-50 v1 through Gluon by the loop of
``examples/gluon/train_resnet50.py`` (``with autograd.record(): loss =
loss_fn(net(x), y)``, ``loss.backward()``, ``trainer.step(batch)`` on a
hybridized net, SGD lr 0.1, momentum 0.9, wd 1e-4,
``SoftmaxCrossEntropyLoss``), full width and depth, in one more:

19. 2 f32 steps at batch 4 (NHWC, the gate on, lr 0.005) on
    ``gpu(0)`` held against the same steps on ``cpu()`` (outputs, losses,
    moving statistics, every gradient and update) with the two controls
    of phase 11; ``autograd.grad(create_graph=True)`` on the card against the
    CPU; the example's loop at its defaults (NCHW, f32, batch 32: 2
    warm-up and 10 timed steps, img/s, the first update must lower the
    loss, the recorded signature one compile then cache hits); the image
    bench's configuration (NHWC, bf16 by ``net.cast``, batch 128) with
    the gate on (2 warm-up and 10 timed steps, the loss must fall, K5
    exactly 6 launches a step, all on the wgmma route) and 10 steps with
    it off (none); ``torch.profiler`` over one gate-on step (device time
    by kernel class, the idle share, K5's launches and ms);

and then drives the ``nd`` core and two of the repository's Gluon
examples with one import changed (`mxnet_tpu_torch/tools/run_example.py`)
in one more:

20. every op of the ``nd`` core (`mxnet_tpu_torch/tools/op_sweep.py`:
    the ops of `ops/elemwise.py`, `init_ops.py`, `shape_ops.py` and
    `reduce.py`, ``Dropout``, ``LeakyReLU``, ``SoftmaxActivation`` and
    ``softmax_cross_entropy``) on ``gpu(0)`` against ``cpu()`` from the
    same inputs, f32 and bf16: the exact families bit for bit, the others
    within their family's limit, each f32 family's control (the card's
    inputs rounded to bf16) above it; ``Dropout`` at p = 0.5 over 2^20
    elements on the card (the zero share within 4 sigma of 0.5,
    survivors scaled by exactly 2, one seed the same mask, the next draw
    another); ``examples/adversary/fgsm_mnist.py`` under ``with
    mx.gpu(0):`` and under ``with mx.cpu():`` (its accuracy lines, its
    net and data on the scope's device); ``examples/gluon/
    train_resnet50.py`` at its defaults (``--ctx tpu``, which is cuda:0,
    ``--num-batches 10``; its img/s line beside phase 19's for the same
    loop), and with ``--dtype bfloat16``, which must raise the dtype
    mismatch the JAX package raises on the same script (the example
    casts the net but not its f32 input).

and then trains ResNet-50 v1 through Gluon with the optimizer layer of
``optimizer.py``, whose one update path (``FusedApplier``) updates every
parameter of a (formula, dtype) group with one launch of
``multi_tensor_update`` (U1, `mxnet_tpu_torch/csrc/multi_tensor_update.cu`),
in (a) the image bench's configuration (NHWC, bf16, batch 128, the gate on)
with SGD momentum 0.9, wd 1e-4 and ``multi_precision`` at lr 0.1, and (b)
the example's defaults (NCHW, f32, batch 32) with Adam at lr 1e-3, wd 1e-4,
in one more:

21. U1 against its plain version (a loop over `ops/optimizer_ops.py`) at
    the shapes of ResNet-50's trainable parameters for each of its five
    formulas (``sgd``, ``sgd_mom``, ``mp_sgd``, ``mp_sgd_mom``, ``adam``)
    over f32
    and bf16 weights, clipping off and on, ``rescale_grad`` 0.25,
    per-tensor lrs and wds, 3 updates (f32 to rtol 1e-6, atol 1e-7; bf16
    weights one bf16 step), 20 calls from the same inputs bit-identical,
    with kernel, plain and fused ``torch.optim`` times (the yardstick
    only) and the bound, for (a)'s and (b)'s formulas; then phase 19's
    card-vs-CPU check with (a)'s and with (b)'s optimizer (Adam at lr
    1e-4; phase 19's controls, and for Adam a third update without its
    bias correction, which must fail); the example's loop at full width
    in (a) and (b) (img/s and the host's issue time beside phase 19's SGD
    rates; U1 exactly one launch a (formula, dtype) group a step, K5
    exactly 6 in (a)); ``torch.profiler`` over one step of each (U1's
    launches, the optimizer's share of the device time and of the
    host's); a
    ``save_states`` / ``load_states`` round trip on the card whose next
    step is bit-identical to the uninterrupted one; and the five Adam
    examples (``vae``, ``gan``, ``autoencoder``, ``recommenders``,
    ``cnn_text_classification``) through ``run_example`` on ``gpu(0)``
    at their tests' arguments, each printing its asserted line.

and then drives the detection slice: SSD and Faster-RCNN through Gluon
with the box ops of `ops/contrib_ops.py` and `ops/detection.py`, greedy
NMS on N1 (`mxnet_tpu_torch/csrc/greedy_nms.cu`) and ``mx.operator.Custom``,
in one more:

22. N1 against its plain version on the card, on the inputs that
    ``Proposal`` hands it at Faster-RCNN's defaults (one 600x1000 image at
    stride 16: 28,728 anchors, 6000 before NMS, threshold 0.7) and that
    ``MultiBoxDetection`` hands it at SSD300's layout (8732 anchors, 21
    classes: batch 32 with ``nms_topk`` 400, batch 2 without) and at the
    examples' own shapes: the keep masks exactly equal, 20 calls
    bit-identical, CUDA-event times of N1, of the whole op and of the
    plain version, the mask pass's and the sweep's device time, the
    bound; every op of the slice (`tools/detection_sweep.py`: the
    examples' shapes and the MultiBox ops at SSD300's layout) on
    ``gpu(0)`` against ``cpu()``, forward and gradients, under
    ``torch.cuda.set_sync_debug_mode("error")``, each family within its
    limit and its control above it; ``examples/ssd/train_ssd.py --ctx
    tpu`` (30 batches of 8; its img/s) and ``examples/rcnn/
    train_faster_rcnn.py`` in its four modes (plain, ``--deformable``,
    ``--ohem``, both) through ``run_example`` on ``gpu(0)`` at their
    tests' step counts, each printing its asserted line, with one
    profiled training iteration of SSD and of the plain Faster-RCNN run
    (device busy, idle share, launches, N1's and U1's share); and a Gluon
    block calling ``F.Custom`` on ``gpu(0)`` against ``cpu()``, eager and
    hybridized, its hybridized program counted as uncaptured.

Phases 3-5 are the serving main path, phase 8 the LM training one,
phase 11's gate-on steps on the card the ResNet one, phase 15's steps on
the card the attention one, phase 16's first launches the rtc one,
phase 18 the inference one, phase 19's steps on the card (its check,
the example's loop and the bf16 gate-on loop) the Gluon training one,
phase 20's two examples the nd-core one, phase 21 after its U1
check the optimizer one and phase 22's examples the detection one:
every kernel's launch count is set to 0 before each and read after it.
The serving path must launch K1, every call by the persistent route; the
LM training path must launch K2 and K3 exactly once per layer and step,
and K1 once per layer and eval batch, K1, K2 and K3 by the persistent
route;
the ResNet path must launch K5 exactly 6 times per step with the gate
on, and never with it off; the attention path must launch K4 once
per layer and step; the rtc path its two kernels once each; the
inference path none of them (no TPU kernel of the repo is on it: K5 is
a dgrad); the Gluon training path K5 exactly 6 times per gate-on step on
the wgmma route, never on NCHW or with the gate off, and no other
kernel; the nd-core path none of them (the examples run an MLP and NCHW
f32 ResNet-50); the LM training path U1 once a step; the optimizer path
U1 once a (formula, dtype) group a step and K5 6 times a gate-on step,
and none of K1-K4 and K6; the detection path N1 and U1 in every example
run and none of K1-K6.
K5's launches in the kernels line are the ResNet path's and the Gluon
path's. Any failed
check exits non-zero. The last lines
are the card's name and power limit (``nvidia-smi``), one JSON line with
every ported kernel's numbers, and the result line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

VOCAB, EMBED, HIDDEN, LAYERS, SEQ = 10000, 650, 650, 2, 35
SEED = 0
SERVED_BATCHES = (1, 8, 32)
RAGGED = (5, 3, 7, 13)          # T, B, I, H: H and B off every tile size
# K1, K2 and K3 are also held to LSTM_ATOL, untimed, at B = 3 and 64, at
# T = 1, and at a shape whose Wh slice does not fit a block's shared
# memory: the step route (one launch per step); every shape at H = 650
# must take the persistent route (one cooperative launch a layer)
EXTRA_SHAPES = [(SEQ, 3, EMBED, HIDDEN), (1, 32, EMBED, HIDDEN),
                (SEQ, 64, EMBED, HIDDEN)]
STEP_ROUTE_SHAPE = (8, 4, 64, 1536)
# K1, K2 and K3 sum in a fixed order: this many calls give the same bits
DETERMINISM_CALLS = 20
# kernel vs plain, f32 on both: the h @ Wh sums (650 terms) run in another
# order than cuBLAS's, and the difference compounds over 35 steps
LSTM_ATOL = 1e-4
# served probabilities, GPU vs CPU (both f32; TF32 off): 1e-4 relative on
# values near 1/VOCAB
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-7
ENGINE_REQUESTS, ENGINE_CLIENTS, ENGINE_MAX_BATCH = 100, 16, 32
# training: the benchmark's batch and optimizer (examples/rnn/word_lm/
# benchmark.py:37,74-76)
TRAIN_BATCH = 32
TRAIN_BATCHES = (8, TRAIN_BATCH)
TRAIN_OPT = {"learning_rate": 1.0, "clip_gradient": 0.25}
SCAN_STEPS, FIT_BATCHES, EVAL_BATCHES = 20, 6, 2
# 2 full-width train steps on the card vs the same Module on the CPU, f32
# both, TF32 off: only summation order differs, in the forward, the
# gradients and through lr 1 into the next step. Outputs are
# probabilities near 1/VOCAB; parameters are up to ~0.3.
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-7
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores and dense bf16 tensor-core FLOP/s, at the
# 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
# time_ms: the card's sleep while the host queues the timed calls, about
# 25 ms at the H100's 1.98 GHz
QUEUE_CYCLES = 50_000_000
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# ResNet-50 v1 training (tools/bench_all.py:91-97)
IMAGE = (224, 224, 3)                     # NHWC
CLASSES, RESNET_BATCH, RESNET_LR = 1000, 128, 0.05
RESNET_WARMUP, RESNET_STEPS = 2, 10
RESNET_CHECK_BATCH = 4
# the six stride-2 1x1 convs of a step, (N, Ho, Wo, K, C): stage 2-4
# body conv1 (K = C / 2) and downsample (K = 2C); and a shape off every
# tile size
K5_SHAPES = [(RESNET_BATCH, ho, ho, k, c) for ho, c in ((28, 256), (14, 512),
                                                        (7, 1024))
             for k in (c // 2, 2 * c)]
K5_RAGGED = (3, 5, 3, 40, 136)
# a bf16 shape TMA cannot address (K and C not multiples of 8): the WMMA
# route
K5_WMMA = (4, 7, 7, 60, 100)
K5_PER_STEP = 6
# K5 vs plain: f32 both sides (TF32 off), sums of K <= 2048 products in
# another order; bf16 outputs are rounded from f32 sums that differ in
# order, which can move a value by one bf16 step (2^-7 relative) near a
# rounding boundary
K5_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# 2 f32 steps of ResNet-50 at batch 4 on the card vs the CPU (TF32 off
# on the card), at the benchmark's lr 0.05, each from the same weights:
# only summation order differs, over 53 convolutions and 53 BatchNorm
# reductions per pass. The forward is well conditioned: outputs and
# moving statistics are held elementwise to rtol 1e-3, atol 1e-5. The
# gradient is not: a ReLU net's gradient jumps where an activation
# crosses zero, and another summation order carries the activations
# nearest zero across it, each flip moving its layer's gradient by a
# visible fraction. So each parameter's gradient, and its update, is
# held by relative norm |g - g_cpu| /
# |g_cpu| to GRAD_REL, set between the largest reading of sound runs on
# the card and the readings of two controls that must fail it (K5's dx
# zeroed; a second update that forgets the momentum), all printed in
# phase 11. On an H100 (700 W) the sound readings were at most 0.090 and
# the controls 1.0 and 0.9996: the limit is about their geometric mean.
RESNET_RTOL, RESNET_ATOL = 1e-3, 1e-5
GRAD_REL = 0.3
# bf16 vs f32 forward (batch statistics, same weights) on BF16_BATCHES
# batches: the row-centred log-probabilities of the bf16 Module against
# the f32 one, by relative norm. Each of the 53 convolutions, 53
# BatchNorms and the classifier rounds to bf16 (8 significant bits), and
# the net amplifies those errors, so the bound is measured: BF16_REL sits
# between the largest sound reading on the card and the readings of two
# controls that must fail it (the bf16 log-probabilities at temperature
# 2, i.e. pulled toward uniform; BatchNorm scaled by 1/var instead of
# 1/sqrt(var)), all printed in phase 11. On an H100 (700 W) the sound
# readings were 0.119-0.120 and the controls 0.507 and 6.99: the limit is
# about the geometric mean of the largest sound and the smallest control.
BF16_BATCHES = 3
BF16_REL = 0.25

# the attention slice: K4 at the widths of tools/perf/attention_bench.py
# (B=1, 8 heads of 128, bf16, causal, T = 4096 / 16384 / 32768), plus
# non-causal and f32 at T=4096 and ragged shapes with Tq != Tk both ways:
# (B, Tq, Tk, H, D, causal, dtype)
K4_CASES = ([(1, t, t, 8, 128, True, torch.bfloat16)
             for t in (4096, 16384, 32768)]
            + [(1, 4096, 4096, 8, 128, False, torch.bfloat16),
               (1, 4096, 4096, 8, 128, True, torch.float32),
               (1, 4096, 4096, 8, 128, False, torch.float32)]
            + [(1, tq, tk, 8, 64, True, dt) for tq, tk in ((1000, 1500),
                                                           (1500, 1000))
               for dt in (torch.bfloat16, torch.float32)])
# K4 vs plain: f32 both sides (the reference's 2e-5); in bf16 both compute
# in f32 and round once to bf16, so a value may land one bf16 step (2^-7
# relative) apart where the two f32 sums straddle a rounding boundary
K4_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2 ** -7, 1e-5)}
# the plain version holds 8*Tq*Tk f32 scores a head batch; above this many
# query rows it runs on the last ATT_SAMPLE rows of every head
ATT_FULL_ROWS, ATT_SAMPLE = 8192, 256
# the attention LM: the long-context example's block structure
# (examples/long-context/train_long_lm.py, vocab 256) at the bench's
# widths, E = 1024 = 8 heads of 128, 2 layers, B=1, on the example's
# synthetic sequences; SGD with momentum 0.9 (the example's Adam is not
# ported) at lr 0.01: at lr 0.05 the loss of this net rises without bound,
# in f32 on the CPU as in bf16 on the card; at 0.01 it falls
ATT_VOCAB, ATT_EMBED, ATT_HEADS, ATT_LAYERS = 256, 1024, 8, 2
ATT_SEQ, ATT_CHECK_SEQ = 4096, 512
ATT_WARMUP, ATT_STEPS = 2, 10
ATT_OPT = {"learning_rate": 0.01, "momentum": 0.9}
# 2 f32 steps at T=512 on the card vs the CPU (TF32 off), each from the
# card's weights: only summation order differs. Outputs (probabilities
# near 1/256) elementwise; gradients and updates by relative norm per
# parameter, as phase 11 holds ResNet-50, to ATT_GRAD_REL, set between
# the sound readings and two controls that must fail it (K4's output
# zeroed; a second update without the momentum), all printed in phase 15.
# On an H100 (700 W) the sound readings were at most 5.6e-4 and the
# controls 0.768 and 6.10: the limit is about the geometric mean of the
# largest sound reading and the smallest control.
ATT_RTOL, ATT_ATOL = 1e-4, 1e-6
ATT_GRAD_REL = 0.02
# K6: axpy over 2^26 f32 (768 MiB moved), a row sum over 4096 x 1000
RTC_N = 1 << 26
RTC_ROWS = (4096, 1000)
# nd.random on the card: 40000 draws a sampler, at the moments'
# tolerances of the JAX package's tests/test_random.py
RANDOM_N = 40000
# ResNet-50 v1 inference through hybridize (bench.py:123-146): batch 32,
# f32, 224x224, NCHW and NHWC; batch 4 against the eager net on cpu();
# batch 16 for the one retrace. The hybridized logits are held to the
# eager logits on the card and on the CPU by relative norm, TF32 off, to
# INFER_REL, set between the sound readings and a control that must fail
# it (one BatchNorm's moving variance doubled), all printed in phase 18.
# On an H100 (700 W) the sound readings were 0 (card, hybridized against
# eager: the same kernels) and at most 1.08e-6 (card against CPU), the
# controls 0.099 (NCHW) and 0.064 (NHWC): the limit is about the
# geometric mean of the largest sound reading and the smallest control.
INFER_BATCH, INFER_CHECK_BATCH, INFER_RETRACE_BATCH = 32, 4, 16
INFER_REL = 2.5e-4
# Gluon training (examples/gluon/train_resnet50.py:45-80): the example's
# defaults (f32, NCHW, batch 32, 224x224, Xavier(magnitude=2), SGD lr 0.1,
# momentum 0.9, wd 1e-4, SoftmaxCrossEntropyLoss, hybridized) and the image
# bench's training configuration (NHWC, bf16 by net.cast, batch 128, with
# MXNET_CONV1X1_PALLAS on); 2 warm-up and 10 timed steps each; 2 f32 steps
# at batch 4 (NHWC, the gate on) on the card against the CPU, held as
# phase 11 holds the Module: output probabilities and moving statistics
# elementwise to RESNET_RTOL/ATOL, gradients and updates by relative norm
# to GRAD_REL, with the same two controls that must fail; at lr 0.005. At
# the example's lr 0.1, and at phase 11's 0.05, the first update takes
# this batch-4 loss from 7 to 51-69 and 26-36 (H100, 700 W), and the
# second step's probabilities, near one-hot, and moving means, near 0
# against activations that large, then miss the elementwise tolerance by
# rounding alone (by 5.4e-4 and 2.2e-4)
GLUON_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
GLUON_CHECK_OPT = dict(GLUON_OPT, learning_rate=0.005)
GLUON_BATCH, GLUON_BF16_BATCH, GLUON_CHECK_BATCH = 32, 128, 4
GLUON_WARMUP, GLUON_STEPS = 2, 10
# a conv bias's gradient, exactly 0 ahead of a BatchNorm, over its
# weight's gradient (by norm): rounding noise reads far below it
BIAS_NOISE = 1e-3
# phase 20: the nd core (Dropout's draw size, the two examples' arguments)
DROPOUT_N = 1 << 20
FGSM_ARGS = ["--num-examples", "600", "--num-epochs", "3"]
RESNET_EXAMPLE_ARGS = ["--num-batches", "10"]
# phase 21: the optimizer layer. (a) the image bench's configuration (NHWC,
# bf16, batch 128, the gate on) trained with SGD momentum and an f32 master
# copy (multi_precision); (b) the example's defaults (NCHW, f32, batch 32)
# trained with Adam; both at full width and depth through the example's loop
OPT_A = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
         "multi_precision": True}
OPT_B = {"learning_rate": 1e-3, "wd": 1e-4}
# the card-vs-CPU check of phase 19 (batch 4, f32) with (a)'s optimizer at
# phase 19's check lr and with (b)'s at lr 1e-4: Adam's first update moves
# every weight by about its lr whatever the gradient, and at 1e-3 (a few
# percent of a conv weight here) the second step's batch-4 BatchNorm
# statistics cancel in both packages, so its output probabilities read
# 1.6e-4 to 2.8e-4 apart (H100, 700 W) against step 0's 4.3e-6 and miss
# the elementwise tolerance by rounding alone
OPT_A_CHECK = dict(OPT_A, learning_rate=GLUON_CHECK_OPT["learning_rate"])
OPT_B_CHECK = dict(OPT_B, learning_rate=1e-4)
# U1 against its plain version, f32: both round every product and sum to
# f32 in the same order (the kernel through __fmul_rn/__fadd_rn, which nvcc
# never contracts, and IEEE sqrt and division); bf16 weights: equal or one
# bf16 step (2^-7 relative) apart
U1_RTOL, U1_ATOL = 1e-6, 1e-7
U1_CALLS = 20
# bytes a value and f32 operations a value of each U1 formula, by the
# weight's (and gradient's) bytes: what it must read and write once
U1_BYTES = {"sgd": lambda b: 3 * b, "sgd_mom": lambda b: 3 * b + 8,
            "mp_sgd": lambda b: 2 * b + 8, "mp_sgd_mom": lambda b: 2 * b + 16,
            "adam": lambda b: 3 * b + 16}
U1_OPS = {"sgd": 5, "sgd_mom": 7, "mp_sgd": 5, "mp_sgd_mom": 7, "adam": 14}
# the five Adam examples at the arguments of tests/test_examples.py and the
# line each of those tests asserts
ADAM_EXAMPLES = [
    ("vae/train_vae.py", ["--num-examples", "1000", "--num-epochs", "15"],
     "VAE TRAINING OK"),
    ("gan/train_gan.py", ["--num-iters", "250"], "sample mean"),
    ("autoencoder/train_autoencoder.py",
     ["--num-examples", "600", "--num-epochs", "12"],
     "final reconstruction loss"),
    ("recommenders/train_mf.py", [], "final test mse"),
    ("cnn_text_classification/train_cnn_text.py",
     ["--num-examples", "1000", "--num-epochs", "4"],
     "final text-cnn accuracy"),
]
# phase 22: the detection slice. N1 (greedy NMS) at Faster-RCNN's Proposal
# defaults (reference contrib/proposal: a 600x1000 image at stride 16, a
# 38x63 map, scales (4, 8, 16, 32) x ratios (0.5, 1, 2) = 12 anchors a
# cell, 28,728 anchors, 6000 before NMS, 300 after, threshold 0.7), and in
# MultiBoxDetection at SSD300's layout (8732 anchors, 21 classes, batch 32
# with nms_topk 400 as reference MXNet's example/ssd deploys, and batch 2
# without it, nms_threshold 0.45)
PROPOSAL_MAP = (38, 63)
PROPOSAL_PARAMS = {"feature_stride": 16, "scales": (4, 8, 16, 32),
                   "ratios": (0.5, 1, 2), "rpn_pre_nms_top_n": 6000,
                   "rpn_post_nms_top_n": 300, "threshold": 0.7,
                   "rpn_min_size": 16}
N1_CALLS = 20
# f32 operations of one IoU test of N1's mask pass: 4 min/max, 2
# subtractions, 2 clamps, a product, a sum and a difference, a clamp, a
# division and the comparison (the areas are per box)
N1_OPS_PER_PAIR = 14
# the examples at the arguments of tests/test_examples.py: SSD (30
# batches of 8, --ctx tpu, which is cuda:0) and Faster-RCNN in its four
# modes, each printing the line its test asserts
SSD_EXAMPLE_ARGS = ["--ctx", "tpu", "--num-batches", "30",
                    "--batch-size", "8"]
RCNN_MODES = [("plain", ["--num-steps", "20"]),
              ("deformable", ["--num-steps", "15", "--deformable"]),
              ("ohem", ["--num-steps", "15", "--ohem"]),
              ("ohem_deformable", ["--num-steps", "10", "--ohem",
                                   "--deformable"])]
# the training iteration profiled in the SSD and the plain Faster-RCNN run:
# the one after this many Trainer steps
PROFILED_AFTER = 10
# the bench's inference function in phase 18: rounds of calls x iters
INFER_ITERS, INFER_CALLS, INFER_ROUNDS = 50, 2, 2
PEAK_TF32_FLOPS = 495e12


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps):
    """Mean device time of ``fn`` in ms, by CUDA events after warm-up. The
    card first sleeps (QUEUE_CYCLES) while the host queues the ``reps``
    calls, so that where the host takes longer to issue a call (the
    wrapper's Python, the launch) than the card to run it, the card's time
    is measured and not the host's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn, attempts=3, complete=None):
    """Run ``fn`` under torch.profiler. Returns the profiled wall time in
    ms and {kernel name: [launches, device ms]}; the kernels are empty
    when the profiler saw no device activity. A run whose trace holds no
    device activity at all, or that ``complete`` (a test of the kernels)
    rejects, is run again, up to ``attempts`` runs: the tracer now and
    then returns an empty trace, or one that lost part of the run."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = {}
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                kernels[e.key[:60]] = [e.count,
                                       e.self_device_time_total / 1e3]
        if kernels and (complete is None or complete(kernels)):
            break
    return wall, kernels


# the name fragments of K1's, K2's and K3's kernels in a profile (K1 and K2:
# both routes of csrc/lstm_persistent.cuh; K3: lstm_bwd_persistent.cuh's
# route and the step route's two kernels)
K1_KERNELS = ("lstm_persistent<false>", "lstm_step<false>")
K2_KERNELS = ("lstm_persistent<true>", "lstm_step<true>")
K3_KERNELS = ("lstm_bwd_persistent", "lstm_bwd_step", "lstm_bwd_dh0")


def kernel_share(kern, fragments, busy):
    """Launches, device ms and share of busy time of the kernels whose
    names hold one of ``fragments``, by name."""
    hits = {k: v for k, v in kern.items() if any(f in k for f in fragments)}
    ms = sum(v[1] for v in hits.values())
    return {"launches": {k: v[0] for k, v in hits.items()}, "ms": ms,
            "share": ms / busy if busy else None}


def recurrence_kernel(plan, kernel):
    """The name fragment of the recurrence kernel that ``plan``'s route of
    K1, K2 or K3 (``kernel``) launches."""
    persistent = plan.route == "persistent"
    if kernel == "k3":
        return "lstm_bwd_persistent" if persistent else "lstm_bwd_step"
    return "%s<%s>" % ("lstm_persistent" if persistent else "lstm_step",
                       "true" if kernel == "k2" else "false")


def recurrence_profile(fn, t, plan, kernel):
    """Launches of K1's, K2's or K3's (``kernel``) recurrence kernel in one
    call of ``fn`` over ``t`` steps, and its device µs a step."""
    _, kern = device_profile(fn)
    name = recurrence_kernel(plan, kernel)
    hits = [v for k, v in kern.items() if name in k]
    check(len(hits) == 1, "one call's profile shows %d %s kernels"
          % (len(hits), name))
    launches, ms = hits[0]
    want = 1 if plan.route == "persistent" else t
    check(launches == want, "one call launched %s %d times, want %d"
          % (name, launches, want))
    return launches, ms * 1e3 / t


def ptxas_of(name, fragment):
    """ptxas's registers and spill bytes for the entry of csrc/<name>.cu
    whose mangled name holds ``fragment``."""
    from mxnet_tpu_torch.ops import _build
    out, entry = {}, ""
    for line in (_build.build_log(name) or "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif fragment in entry:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out["spill_store_bytes"] = int(m.group(1))
                out["spill_load_bytes"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out["registers"] = int(m.group(1))
    check("registers" in out, "no ptxas report for %s in %s"
          % (fragment, name))
    return out


def check_route(wrapper, plan, before, what):
    """The one call since ``before`` (a copy of ``launches_by_route``) took
    ``plan``'s route."""
    took = [r for r, n in wrapper.launches_by_route.items()
            if n != before[r]]
    check(took == [plan.route], "%s took route %s, its plan says %s"
          % (what, took, plan.route))
    return took[0]


def check_deterministic(fn, args, what):
    """DETERMINISM_CALLS calls of ``fn`` give the same bits."""
    first = [o.clone() for o in fn(*args)]
    for n in range(DETERMINISM_CALLS - 1):
        for k, (g, w) in enumerate(zip(fn(*args), first)):
            check(torch.equal(g, w), "%s output %d of call %d differs from "
                  "call 1's bits" % (what, k, n + 2))
    return DETERMINISM_CALLS


def lstm_inputs(t, b, i, h, device, seed):
    """One LSTM layer's inputs; weights at PyTorch's LSTM init scale."""
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(h)

    def u(scale, *shape):
        return torch.from_numpy(rng.uniform(-scale, scale, shape)
                                .astype(np.float32)).to(device)
    return (u(1.0, t, b, i), u(0.5, b, h), u(0.5, b, h),
            u(k, i, 4 * h), u(k, h, 4 * h), u(k, 4 * h))


def lstm_bound_ms(t, b, i, h):
    """Least time for one layer: every input read once and every output
    written once, or the matrix products' f32 operations, whichever is
    larger. Returns (ms, "bytes" | "operations")."""
    nbytes = 4 * (t * b * i + 2 * b * h + i * 4 * h + h * 4 * h + 4 * h
                  + t * b * h + 2 * b * h)
    flops = 2 * t * b * 4 * h * (i + h)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cudnn_lstm(x, h0, c0, wx, wh, b):
    """torch.nn.LSTM (cuDNN) with the same weights: the yardstick only."""
    inp, hid = wx.shape[0], wh.shape[0]
    lstm = torch.nn.LSTM(inp, hid).to(x.device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(wx.t())
        lstm.weight_hh_l0.copy_(wh.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
    return lambda: lstm(x, (h0[None], c0[None]))


def phase_kernel(ops, device):
    """fused_lstm kernel vs plain at the served shapes (timed), the extra
    shapes, the step route's and a ragged one; each call's route against
    its plan; bitwise determinism at B=32."""
    fused_lstm, plain = ops.fused_lstm, ops.fused_lstm_plain
    rows = []
    worst = 0.0
    served = [(SEQ, b, EMBED, HIDDEN) for b in SERVED_BATCHES]
    shapes = served + EXTRA_SHAPES + [STEP_ROUTE_SHAPE, RAGGED]
    log("phase 2 fused_lstm ptxas %s" % json.dumps({
        "lstm_persistent": ptxas_of("fused_lstm", "lstm_persistent"),
        "lstm_step": ptxas_of("fused_lstm", "lstm_step")}))
    for n, (t, b, i, h) in enumerate(shapes):
        args = lstm_inputs(t, b, i, h, device, SEED + n)
        plan = ops.lstm_plan(b, h, device)
        check(plan.route == ("step" if (t, b, i, h) == STEP_ROUTE_SHAPE
                             else "persistent"),
              "the plan at %s is %s" % ((t, b, i, h), plan))
        with torch.no_grad():
            before = dict(fused_lstm.launches_by_route)
            got = fused_lstm(*args)
            check_route(fused_lstm, plan, before, "fused_lstm %s"
                        % ((t, b, i, h),))
            want = plain(*args)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            check(all(bool(torch.isfinite(g).all()) for g in got),
                  "fused_lstm output not finite at %s" % ((t, b, i, h),))
            check(err <= LSTM_ATOL, "fused_lstm vs plain max abs err %.3g "
                  "> %.1g at T=%d B=%d I=%d H=%d" % (err, LSTM_ATOL, t, b,
                                                     i, h))
            worst = max(worst, err)
            row = {"T": t, "B": b, "I": i, "H": h, "max_abs_err": err,
                   "plan": plan._asdict()}
            if (t, b, i, h) in served:
                lib = cudnn_lstm(*args)
                lib_err = float((lib()[0] - got[0]).abs().max())
                bound, by = lstm_bound_ms(t, b, i, h)
                row.update(
                    ms=time_ms(lambda: fused_lstm(*args), 20),
                    plain_ms=time_ms(lambda: plain(*args), 20),
                    library_ms=time_ms(lib, 20), library_max_abs_err=lib_err,
                    bound_ms=bound, bound_by=by)
                # the recurrence kernel's launches in one call, and its own
                # device time per step
                launches, us = recurrence_profile(lambda: fused_lstm(*args),
                                                  t, plan, "k1")
                row.update(recurrence_launches_per_call=launches,
                           recurrence_us_per_step=us)
            if (t, b, i, h) == served[-1]:
                row["bitwise_identical_calls"] = check_deterministic(
                    fused_lstm, args, "fused_lstm %s" % ((t, b, i, h),))
        log("phase 2 fused_lstm %s" % json.dumps(row))
        rows.append(row)
    return rows, worst


def lm_symbol(mx):
    """The served graph, batch-major at both ends (the engine batches
    along axis 0; RNN is time-major)."""
    data = mx.sym.var("data")
    x = mx.sym.Embedding(data, input_dim=VOCAB, output_dim=EMBED,
                         name="embed")
    x = mx.sym.SwapAxis(x, dim1=0, dim2=1, name="to_tnc")
    x = mx.sym.RNN(x, state_size=HIDDEN, num_layers=LAYERS, mode="lstm",
                   name="lstm")
    x = mx.sym.SwapAxis(x, dim1=0, dim2=1, name="to_ntc")
    x = mx.sym.FullyConnected(x, num_hidden=VOCAB, flatten=False,
                              name="decoder")
    return mx.sym.softmax(x, axis=-1, name="prob")


def lm_params(sym, seed):
    """Seeded weights (uniform +-0.1, the word_lm init scale); the RNN
    begin states are inputs, not weights."""
    rng = np.random.RandomState(seed)
    shapes, _, _ = sym.infer_shape(data=(1, SEQ))
    return {name: rng.uniform(-0.1, 0.1, shape).astype(np.float32)
            for name, shape in zip(sym.list_arguments(), shapes)
            if name not in ("data", "lstm_state", "lstm_state_cell")}


def tokens(rng, n):
    return rng.randint(0, VOCAB, (n, SEQ)).astype(np.float32)


def check_probs(out, n, what):
    check(out.shape == (n, SEQ, VOCAB), "%s shape %s" % (what, out.shape))
    check(bool(np.isfinite(out).all()), "%s not finite" % what)
    check(np.allclose(out.sum(-1), 1.0, atol=1e-4),
          "%s rows do not sum to 1" % what)


class Reference:
    """CPU predictors of the same model, one per row count."""

    def __init__(self, mx, sym_json, params):
        self._base = mx.Predictor(sym_json, params, ctx=mx.cpu(),
                                  input_shapes={"data": (1, SEQ)})
        self._preds = {1: self._base}

    def __call__(self, toks):
        n = toks.shape[0]
        if n not in self._preds:
            self._preds[n] = self._base.sibling({"data": (n, SEQ)})
        pred = self._preds[n]
        pred.forward(data=toks)
        return pred.get_output(0)


def compare(got, want, what):
    err = float(np.abs(got - want).max())
    check(np.allclose(got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL),
          "%s differs from the CPU reference (max abs err %.3g)"
          % (what, err))
    return err


def phase_predictor(mx, sym_json, params, ref, rng, ctx):
    n = 4
    pred = mx.Predictor(sym_json, params, ctx=ctx,
                        input_shapes={"data": (n, SEQ)})
    toks = tokens(rng, n)
    before = mx.ops.fused_lstm.launches
    pred.forward(data=toks)
    out = pred.get_output(0)
    grew = mx.ops.fused_lstm.launches - before
    if ctx.device_type == "gpu":
        check(grew == LAYERS, "one forward launched fused_lstm %d times, "
              "want %d (one per layer)" % (grew, LAYERS))
    check_probs(out, n, "Predictor output")
    err = compare(out, ref(toks), "Predictor output")
    log("phase 3 predictor %s" % json.dumps({
        "rows": n, "fused_lstm_launches_per_forward": grew,
        "max_abs_err_vs_cpu": err}))


def phase_engine(mx, sym_json, params, ref, rng, ctx):
    cfg = mx.serving.EngineConfig(max_batch_size=ENGINE_MAX_BATCH,
                                  max_batch_delay_ms=2.0,
                                  max_queue=2 * ENGINE_REQUESTS)
    engine = mx.serving.InferenceEngine(sym_json, params,
                                        input_shapes={"data": (SEQ,)},
                                        ctx=ctx, config=cfg)
    reqs = [tokens(rng, int(rng.randint(1, 9)))
            for _ in range(ENGINE_REQUESTS)]

    def one(toks):
        t0 = time.perf_counter()
        out = engine.predict({"data": toks}, timeout=300)[0]
        return out, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(ENGINE_CLIENTS) as pool:
        results = list(pool.map(one, reqs))
    wall = time.perf_counter() - t0
    for toks, (out, _) in zip(reqs, results):
        check_probs(out, toks.shape[0], "engine output")
    sample = range(0, ENGINE_REQUESTS, ENGINE_REQUESTS // 8)
    err = max(compare(results[i][0], ref(reqs[i]), "engine request %d" % i)
              for i in sample)
    lat = np.array([lat for _, lat in results]) * 1e3
    rows = sum(r.shape[0] for r in reqs)
    st = engine.stats()
    check(st["requests"].get("ok") == ENGINE_REQUESTS,
          "engine request counts %s" % st["requests"])
    log("phase 4 engine %s" % json.dumps({
        "requests": ENGINE_REQUESTS, "clients": ENGINE_CLIENTS,
        "rows": rows, "wall_s": wall,
        "requests_per_s": ENGINE_REQUESTS / wall,
        "tokens_per_s": rows * SEQ / wall,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "warmup_s": st["warmup_seconds"],
        "pad_waste": st["padding"]["waste_ratio"],
        "batches": {b: v["batches"]
                    for b, v in st["padding"]["buckets"].items()},
        "sampled": len(sample), "max_abs_err_vs_cpu": err}))
    return engine


def phase_http(mx, engine, ref, rng):
    server = mx.serving.serve(engine, port=0, allow_shutdown=True)
    base = "http://127.0.0.1:%d" % server.port
    # a local server: never route through a proxy from the environment
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def call(path, doc=None):
        body = None if doc is None else json.dumps(doc).encode()
        req = urllib.request.Request(base + path, data=body, method=(
            "GET" if doc is None else "POST"),
            headers={"Content-Type": "application/json"})
        with opener.open(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())

    errs = []
    for _ in range(2):
        toks = tokens(rng, 1)
        code, doc = call("/predict", {"inputs": {"data": toks.tolist()}})
        check(code == 200, "/predict answered %d" % code)
        out = np.asarray(doc["outputs"][0], dtype=np.float32)
        check_probs(out, 1, "/predict output")
        errs.append(compare(out, ref(toks), "/predict output"))
    code, health = call("/healthz")
    check(code == 200 and health["status"] == "ok",
          "/healthz answered %d %s" % (code, health.get("status")))
    code, _ = call("/shutdown", {})
    check(code == 200, "/shutdown answered %d" % code)
    check(server.join(timeout=120) and engine.stats()["closed"],
          "server did not stop after /shutdown")
    log("phase 5 http %s" % json.dumps({
        "predict_requests": 2, "max_abs_err_vs_cpu": max(errs),
        "healthz": health["status"]}))


def phase_profile(mx, sym_json, params, rng):
    """Where a served forward's device time goes, at the top bucket."""
    n = ENGINE_MAX_BATCH
    pred = mx.Predictor(sym_json, params, ctx=mx.gpu(0),
                        input_shapes={"data": (n, SEQ)})
    toks = tokens(rng, n)
    pred.forward(data=toks)      # warm: allocations, first launches
    # a trace that lost K1's launches (seen once on the process's first
    # profile) is taken again, as the other phases' profiles are
    wall, kern = device_profile(
        lambda: pred.forward(data=toks),
        complete=lambda k: bool(kernel_share(k, K1_KERNELS, 1.0)["launches"]))
    busy = sum(ms for _, ms in kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:6]
    k1 = kernel_share(kern, K1_KERNELS, busy)
    log("phase 6 profile %s" % json.dumps({
        "rows": n, "forward_wall_ms": wall, "device_busy_ms": busy,
        "device_idle_share": (1 - busy / wall) if kern else None,
        "k1": k1,
        "top_kernels": [{"kernel": k, "launches": c, "ms": ms,
                         "share": ms / busy} for k, (c, ms) in top]}))
    check(list(k1["launches"].values()) == [LAYERS]
          and "lstm_persistent" in next(iter(k1["launches"])),
          "a served forward's profile shows K1 kernels %s, want one "
          "lstm_persistent launch per layer (%d)" % (k1["launches"], LAYERS))


# ---------------------------------------------------------------------------
# the training slice: K2/K3 and Module training of the same LM
# ---------------------------------------------------------------------------
def bound_ms(nbytes, flops):
    """The larger of bytes over HBM bandwidth and f32 operations over the
    CUDA cores' peak: (ms, "bytes" | "operations")."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def train_bounds(t, b, i, h):
    """Bounds of the two timed wrappers, f32, each input read and each
    output written once.

    K2, ``fused_lstm_train``: reads x, h0, c0, wx, wh, b; writes hseq,
    cseq and gates; 2·T·B·4H·(I+H) operations (the input projection it
    runs and the recurrence). K3, ``lstm_bwd_recurrence``: reads dhseq,
    dh_n, dc_n, gates, cseq, c0, wh; writes dgates, dh0, dc0;
    2·T·B·4H·H operations (T carry products, the last one dh0)."""
    bh, g = b * h, 4 * h
    k2 = bound_ms(4 * (t * b * i + 2 * bh + i * g + h * g + g
                       + 2 * t * bh + t * b * g),
                  2 * t * b * g * (i + h))
    k3 = bound_ms(4 * (t * bh + 2 * bh + t * b * g + t * bh + bh + h * g
                       + t * b * g + 2 * bh),
                  2 * t * b * g * h)
    return k2, k3


def cudnn_train(x, h0, c0, wx, wh, b, cots):
    """torch.nn.LSTM (cuDNN) with the same weights, for the yardstick
    only: (training forward, backward of one retained forward, forward +
    backward) as callables."""
    inp, hid = wx.shape[0], wh.shape[0]
    lstm = torch.nn.LSTM(inp, hid).to(x.device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(wx.t())
        lstm.weight_hh_l0.copy_(wh.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
    leaves = [a.detach().requires_grad_(True) for a in (x, h0, c0)]
    wrt = leaves + list(lstm.parameters())

    def fwd():
        y, (hn, cn) = lstm(leaves[0], (leaves[1][None], leaves[2][None]))
        return [y, hn[0], cn[0]]
    kept = fwd()
    return (fwd,
            lambda: torch.autograd.grad(kept, wrt, cots, retain_graph=True),
            lambda: torch.autograd.grad(fwd(), wrt, cots))


def max_err(got, want, what, rtol=LSTM_ATOL, atol=LSTM_ATOL):
    """Max abs difference of two tensor lists; fails unless every pair is
    within ``atol + rtol * |want|`` and finite."""
    worst = 0.0
    for n, (g, w) in enumerate(zip(got, want)):
        check(bool(torch.isfinite(g).all()), "%s output %d not finite"
              % (what, n))
        check(bool(torch.allclose(g, w, rtol=rtol, atol=atol)),
              "%s output %d differs from the plain version (max abs err "
              "%.3g)" % (what, n, float((g - w).abs().max())))
        worst = max(worst, float((g - w).abs().max()))
    return worst


def cotangents(t, b, h, device, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(device)
            for s in ((t, b, h), (b, h), (b, h))]


def k3_check(ops, plan, bwd_args, shape):
    """One K3 call against its plain version; its route against ``plan``.
    Returns (max abs err, route)."""
    before = dict(ops.lstm_bwd_recurrence.launches_by_route)
    got = ops.lstm_bwd_recurrence(*bwd_args)
    route = check_route(ops.lstm_bwd_recurrence, plan, before,
                        "lstm_bwd_recurrence %s" % (shape,))
    err = max_err(got, ops.lstm_bwd_recurrence_plain(*bwd_args),
                  "lstm_bwd_recurrence %s" % (shape,))
    return err, route


def phase_train_kernels(ops, device):
    """K2 (fused_lstm_train) and K3 (lstm_bwd_recurrence) against their
    plain versions, and the six gradients of a FusedLSTM layer against
    the plain backward, at T=35, B in {8, 32}, I=H=650 and a ragged
    shape; kernel, plain and cuDNN times with each kernel's bound. K2 and
    K3 at the extra shapes and the step route's; each call's route
    against its plan; K2's and K3's recurrence launches a call, µs a step
    and bitwise determinism at B=32."""
    rows = []
    worst = 0.0
    k3_units = ops.lstm_bwd_plan(TRAIN_BATCH, HIDDEN, device).units
    log("phase 7 fused_lstm_train ptxas %s" % json.dumps({
        "lstm_persistent": ptxas_of("fused_lstm_train", "lstm_persistent"),
        "lstm_step": ptxas_of("fused_lstm_train", "lstm_step"),
        "lstm_bwd_persistent<%d>" % k3_units: ptxas_of(
            "fused_lstm_train", "lstm_bwd_persistentILi%dE" % k3_units),
        "lstm_bwd_step": ptxas_of("fused_lstm_train", "lstm_bwd_step")}))
    for n, shape in enumerate(EXTRA_SHAPES + [STEP_ROUTE_SHAPE]):
        t, b, i, h = shape
        args = lstm_inputs(*shape, device, SEED + 30 + n)
        plan = ops.lstm_plan(b, h, device)
        bplan = ops.lstm_bwd_plan(b, h, device)
        check(bplan.route == ("step" if shape == STEP_ROUTE_SHAPE
                              else "persistent"),
              "K3's plan at %s is %s" % (shape, bplan))
        with torch.no_grad():
            before = dict(ops.fused_lstm_train.launches_by_route)
            got = ops.fused_lstm_train(*args)
            route = check_route(ops.fused_lstm_train, plan, before,
                                "fused_lstm_train %s" % (shape,))
            err = max_err(got, ops.fused_lstm_train_plain(*args),
                          "fused_lstm_train %s" % (shape,))
            bwd_args = (*cotangents(t, b, h, device, SEED + 40 + n),
                        got[2], got[1], args[2], args[4])
            err3, route3 = k3_check(ops, bplan, bwd_args, shape)
        worst = max(worst, err, err3)
        log("phase 7 train kernels %s" % json.dumps({
            "T": t, "B": b, "I": i, "H": h, "k2_max_abs_err": err,
            "route": route, "plan": plan._asdict(), "k3_max_abs_err": err3,
            "k3_route": route3, "k3_plan": bplan._asdict()}))
    shapes = [(SEQ, b, EMBED, HIDDEN) for b in TRAIN_BATCHES] + [RAGGED]
    for n, (t, b, i, h) in enumerate(shapes):
        args = lstm_inputs(t, b, i, h, device, SEED + 10 + n)
        plan = ops.lstm_plan(b, h, device)
        bplan = ops.lstm_bwd_plan(b, h, device)
        cots = cotangents(t, b, h, device, SEED + 20 + n)
        x, h0, c0, wx, wh, bias = args
        with torch.no_grad():
            res = ops.fused_lstm_train_plain(*args)
            before = dict(ops.fused_lstm_train.launches_by_route)
            err2 = max_err(ops.fused_lstm_train(*args), res,
                           "fused_lstm_train %s" % ((t, b, i, h),))
            route = check_route(ops.fused_lstm_train, plan, before,
                                "fused_lstm_train %s" % ((t, b, i, h),))
            check(route == "persistent", "fused_lstm_train at %s took the "
                  "%s route" % ((t, b, i, h), route))
            bwd_args = (*cots, res[2], res[1], c0, wh)
            err3, route3 = k3_check(ops, bplan, bwd_args, (t, b, i, h))
            check(route3 == "persistent", "lstm_bwd_recurrence at %s took "
                  "the %s route" % ((t, b, i, h), route3))
            want = ops.fused_lstm_backward_plain(*cots, x, h0, c0, wx, wh,
                                                 *res)
        leaves = [a.detach().requires_grad_(True) for a in args]
        got = torch.autograd.grad(ops.FusedLSTM.apply(*leaves), leaves,
                                  cots)
        err_g = max_err(got, want, "FusedLSTM gradients %s"
                        % ((t, b, i, h),))
        worst = max(worst, err2, err3, err_g)
        row = {"T": t, "B": b, "I": i, "H": h, "k2_max_abs_err": err2,
               "k3_max_abs_err": err3, "grad_max_abs_err": err_g,
               "route": route, "plan": plan._asdict(), "k3_route": route3,
               "k3_plan": bplan._asdict()}
        if (t, b, i, h) != RAGGED:
            (k2b, k2by), (k3b, k3by) = train_bounds(t, b, i, h)
            lib_fwd, lib_bwd, lib_both = cudnn_train(*args, cots)

            def layer():
                return torch.autograd.grad(ops.FusedLSTM.apply(*leaves),
                                           leaves, cots)
            with torch.no_grad():
                row.update(
                    k2_ms=time_ms(lambda: ops.fused_lstm_train(*args), 20),
                    k2_plain_ms=time_ms(
                        lambda: ops.fused_lstm_train_plain(*args), 20),
                    k2_bound_ms=k2b, k2_bound_by=k2by,
                    k3_ms=time_ms(lambda: ops.lstm_bwd_recurrence(
                        *bwd_args), 20),
                    k3_plain_ms=time_ms(lambda: ops.lstm_bwd_recurrence_plain(
                        *bwd_args), 20),
                    k3_bound_ms=k3b, k3_bound_by=k3by,
                    backward_ms=time_ms(lambda: ops.fused_lstm_backward(
                        *cots, x, h0, c0, wx, wh, *res), 20))
                launches, us = recurrence_profile(
                    lambda: ops.fused_lstm_train(*args), t, plan, "k2")
                row.update(k2_recurrence_launches_per_call=launches,
                           k2_recurrence_us_per_step=us)
                # K3's recurrence kernel: one launch a call on its route
                launches, us = recurrence_profile(
                    lambda: ops.lstm_bwd_recurrence(*bwd_args), t, bplan,
                    "k3")
                row.update(k3_recurrence_launches_per_call=launches,
                           k3_step_us=us)
                if b == TRAIN_BATCH:
                    row["k2_bitwise_identical_calls"] = check_deterministic(
                        ops.fused_lstm_train, args, "fused_lstm_train %s"
                        % ((t, b, i, h),))
                    row["k3_bitwise_identical_calls"] = check_deterministic(
                        ops.lstm_bwd_recurrence, bwd_args,
                        "lstm_bwd_recurrence %s" % ((t, b, i, h),))
            row.update(layer_fwd_bwd_ms=time_ms(layer, 20),
                       cudnn_fwd_ms=time_ms(lib_fwd, 20),
                       cudnn_bwd_ms=time_ms(lib_bwd, 20),
                       cudnn_fwd_bwd_ms=time_ms(lib_both, 20))
        log("phase 7 train kernels %s" % json.dumps(row))
        rows.append(row)
    return rows, worst


def bench_symbol(mx, reshape_label=False):
    """The training benchmark's graph (`examples/rnn/word_lm/
    benchmark.py:52-58`), time-major data (T, B), labels (T*B,). With
    ``reshape_label`` the label is a (T, B) input reshaped in the graph,
    the reference word_lm `train.py:74-84` form, so an NDArrayIter that
    cuts (T, B) batches feeds it."""
    data = mx.sym.var("data")
    x = mx.sym.Embedding(data, input_dim=VOCAB, output_dim=EMBED,
                         name="embed")
    x = mx.sym.RNN(x, state_size=HIDDEN, num_layers=LAYERS, mode="lstm",
                   name="lstm")
    x = mx.sym.FullyConnected(mx.sym.Reshape(x, shape=(-1, HIDDEN)),
                              num_hidden=VOCAB, name="decoder")
    if reshape_label:
        label = mx.sym.Reshape(mx.sym.var("softmax_label"), shape=(-1,))
        return mx.sym.SoftmaxOutput(x, label, name="softmax")
    return mx.sym.SoftmaxOutput(x, name="softmax")


def train_module(mx, ctx):
    """bind, seeded Xavier init and SGD (lr 1, clip 0.25), as the
    benchmark does; rescale_grad is 1/T (data is (T, B))."""
    mod = mx.mod.Module(bench_symbol(mx), context=ctx)
    mod.bind(data_shapes=[("data", (SEQ, TRAIN_BATCH))],
             label_shapes=[("softmax_label", (SEQ * TRAIN_BATCH,))])
    mx.random.seed(SEED)
    mod.init_params(initializer=mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=TRAIN_OPT)
    return mod


def lm_batches(mx, rng, n):
    """n batches of random token ids, on the CPU (Module copies them)."""
    return [mx.io.DataBatch(
        data=[mx.nd.array(rng.randint(0, VOCAB, (SEQ, TRAIN_BATCH)))],
        label=[mx.nd.array(rng.randint(0, VOCAB, SEQ * TRAIN_BATCH))])
        for _ in range(n)]


def lm_iter(mx, rng, batches):
    """NDArrayIter over ``batches`` (T, B) slices of random token ids."""
    shape = (batches * SEQ, TRAIN_BATCH)
    return mx.io.NDArrayIter(rng.randint(0, VOCAB, shape).astype(np.float32),
                             rng.randint(0, VOCAB, shape).astype(np.float32),
                             batch_size=SEQ)


def sync(ctx):
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()


def phase_train(mx, ctx, rng):
    """The training main path on ``ctx``: 2 steps held against the same
    Module on the CPU, 20 timed steps of ``_step_scan`` after 2 warm-up
    steps, then ``fit`` for one short epoch and ``score``. Returns
    (module, summary)."""
    mod = train_module(mx, ctx)
    ref = train_module(mx, mx.cpu())
    for name, arr in mod.get_params()[0].items():
        check(np.array_equal(arr.asnumpy(),
                             ref.get_params()[0][name].asnumpy()),
              "seeded init of %s differs between %s and cpu" % (name, ctx))
    batches = lm_batches(mx, rng, 4 + 2 * SCAN_STEPS)
    out_err = 0.0
    for step, batch in enumerate(batches[:2]):
        mod._step(batch)
        ref._step(batch)
        got = mod.get_outputs()[0].asnumpy()
        want = ref.get_outputs()[0].asnumpy()
        check(got.shape == (SEQ * TRAIN_BATCH, VOCAB)
              and bool(np.isfinite(got).all()),
              "train step %d output %s not finite" % (step, got.shape))
        check(np.allclose(got, want, rtol=TRAIN_RTOL, atol=TRAIN_ATOL),
              "train step %d output differs from the CPU module (max abs "
              "err %.3g)" % (step, float(np.abs(got - want).max())))
        out_err = max(out_err, float(np.abs(got - want).max()))
    param_err = {}
    for name, arr in mod.get_params()[0].items():
        got, want = arr.asnumpy(), ref.get_params()[0][name].asnumpy()
        check(np.allclose(got, want, rtol=PARAM_RTOL, atol=PARAM_ATOL),
              "%s after 2 steps differs from the CPU module (max abs err "
              "%.3g)" % (name, float(np.abs(got - want).max())))
        param_err[name] = float(np.abs(got - want).max())
    del ref

    for batch in batches[2:4]:           # warm-up
        mod._step(batch)

    def step_loop(group):
        """Per-batch ``_step``s (the fit loop's path): seconds."""
        sync(ctx)
        t = time.perf_counter()
        for b in group:
            mod._step(b)
        sync(ctx)
        return time.perf_counter() - t
    half = SCAN_STEPS // 2
    loop_s = step_loop(batches[4:4 + half])
    sync(ctx)
    t0 = time.perf_counter()
    stacked = mod._step_scan(batches[4 + half:4 + half + SCAN_STEPS])
    sync(ctx)
    wall = time.perf_counter() - t0
    loop_s += step_loop(batches[4 + half + SCAN_STEPS:])
    outs = stacked[0].data
    check(tuple(outs.shape) == (SCAN_STEPS, SEQ * TRAIN_BATCH, VOCAB)
          and bool(torch.isfinite(outs).all()),
          "_step_scan outputs %s not finite" % (tuple(outs.shape),))
    del stacked, outs

    fit_mod = mx.mod.Module(bench_symbol(mx, reshape_label=True),
                            context=ctx)
    speedo = mx.callback.Speedometer(SEQ * TRAIN_BATCH, frequent=2,
                                     auto_reset=False)
    train_ppl = mx.metric.Perplexity()
    t1 = time.perf_counter()
    fit_mod.fit(lm_iter(mx, rng, FIT_BATCHES), eval_metric=train_ppl,
                batch_end_callback=speedo, optimizer="sgd",
                optimizer_params=TRAIN_OPT, arg_params=mod.get_params()[0],
                num_epoch=1)
    sync(ctx)
    fit_wall = time.perf_counter() - t1
    k1_before = mx.ops.fused_lstm.launches
    (_, eval_ppl), = fit_mod.score(lm_iter(mx, rng, EVAL_BATCHES),
                                   mx.metric.Perplexity())
    k1_by_score = mx.ops.fused_lstm.launches - k1_before
    check(np.isfinite(train_ppl.get()[1]) and np.isfinite(eval_ppl),
          "perplexity not finite: train %s, eval %s"
          % (train_ppl.get()[1], eval_ppl))
    check(speedo.history, "Speedometer logged nothing")
    summary = {
        "steps_vs_cpu": 2, "output_max_abs_err_vs_cpu": out_err,
        "param_max_abs_err_vs_cpu": param_err,
        "scan_steps": SCAN_STEPS, "scan_wall_s": wall,
        "tokens_per_s": SCAN_STEPS * SEQ * TRAIN_BATCH / wall,
        "steps_per_s": SCAN_STEPS / wall,
        "step_loop_steps": 2 * half,
        "step_loop_tokens_per_s": 2 * half * SEQ * TRAIN_BATCH / loop_s,
        "fit_batches": FIT_BATCHES, "fit_wall_s": fit_wall,
        "fit_train_perplexity": train_ppl.get()[1],
        "speedometer_samples_per_s": [s for _, _, s in speedo.history],
        "eval_batches": EVAL_BATCHES, "eval_perplexity": eval_ppl,
        "k1_launches_by_score": k1_by_score}
    return mod, summary


def phase_train_profile(mod, rng, mx):
    """Where one train step's device time goes."""
    batch = lm_batches(mx, rng, 1)[0]

    def both_recurrences(kern):
        # a trace that lost the forward (or the backward) is taken again;
        # the checks below still hold the trace that is kept
        return all(any(f in k for k in kern for f in frags)
                   for frags in (K2_KERNELS, K3_KERNELS))
    wall, kern = device_profile(lambda: mod._step(batch),
                                complete=both_recurrences)
    busy = sum(ms for _, ms in kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:10]
    k2 = kernel_share(kern, K2_KERNELS, busy)
    k3 = kernel_share(kern, K3_KERNELS, busy)
    log("phase 9 train profile %s" % json.dumps({
        "step_wall_ms": wall, "device_busy_ms": busy,
        "device_idle_share": (1 - busy / wall) if kern else None,
        "k2": k2, "k3": k3,
        "top_kernels": [{"kernel": k, "launches": c, "ms": ms,
                         "share": ms / busy} for k, (c, ms) in top]}))
    check(list(k2["launches"].values()) == [LAYERS]
          and "lstm_persistent" in next(iter(k2["launches"])),
          "a train step's profile shows K2 kernels %s, want one "
          "lstm_persistent launch per layer (%d)" % (k2["launches"], LAYERS))
    check(list(k3["launches"].values()) == [LAYERS]
          and "lstm_bwd_persistent" in next(iter(k3["launches"])),
          "a train step's profile shows K3 kernels %s, want one "
          "lstm_bwd_persistent launch per layer (%d)"
          % (k3["launches"], LAYERS))


# ---------------------------------------------------------------------------
# the ResNet slice: K5 and ResNet-50 v1 training through Gluon and Module
# ---------------------------------------------------------------------------
def k5_times(n, ho, wo, k, c, dtype):
    """The two least times of one K5 call, in ms: its bytes (dy and w2
    read once, dx, four times the product, written once) at the HBM rate,
    and its 2·M·K·C operations at the dtype's peak."""
    item = 2 if dtype == torch.bfloat16 else 4
    m = n * ho * wo
    nbytes = item * (m * k + k * c + 4 * m * c)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    return nbytes / PEAK_BYTES_PER_S * 1e3, 2 * m * k * c / peak * 1e3


def bound_of(t_bytes, t_ops):
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cudnn_dgrad(dy, w2, h, w):
    """cuDNN's input gradient of the same NHWC 1x1 stride-2 conv, on
    channels-last tensors: the yardstick only."""
    n, _, _, k = dy.shape
    c = w2.shape[1]
    w4 = w2.reshape(k, 1, 1, c).permute(0, 3, 1, 2)     # OHWI as OIHW view
    dyc = dy.permute(0, 3, 1, 2)
    return lambda: torch.nn.grad.conv2d_input((n, c, h, w), w4, dyc,
                                              stride=2).permute(0, 2, 3, 1)


def k5_ptxas(ops):
    """The wgmma route's kernels by tile width (``wgmma_ptxas``); fails
    on spills or serialised wgmmas."""
    out = wgmma_ptxas("conv1x1_s2_dgrad", ops.conv_kernel._library(),
                      "dgrad_wgmmaILi%dE", "BN=%d",
                      ops.conv_kernel._wgmma_smem)
    for bn, row in out.items():
        check(row["spill_stores"] == 0 and row["spill_loads"] == 0
              and not row["wgmma_serialized"],
              "conv1x1_s2_dgrad wgmma %s spills or serialises: %s"
              % (bn, row))
    return out


def phase_k5(ops, device):
    """K5 vs plain at the train step's six shapes (bf16 and f32), a ragged
    one and one the WMMA route takes; each call's route against its plan
    (the six bf16 sites on the wgmma route); kernel, plain and cuDNN times
    at the six; 20 bit-identical calls at stage 2's downsample."""
    k5 = ops.conv1x1_s2_dgrad
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for n_shape, shape in enumerate(K5_SHAPES + [K5_RAGGED, K5_WMMA]):
            n, ho, wo, k, c = shape
            gen = torch.Generator(device=device)
            gen.manual_seed(SEED + 30 + n_shape)
            dy = torch.randn((n, ho, wo, k), generator=gen,
                             device=device).to(dtype)
            w2 = (torch.randn((k, c), generator=gen, device=device)
                  / k ** 0.5).to(dtype)
            plan = ops.conv_kernel.conv1x1_s2_dgrad_plan(dy, w2)
            before = dict(k5.launches_by_route)
            got = k5(dy, w2, 2 * ho, 2 * wo)
            what = "conv1x1_s2_dgrad %s %s" % (shape, dtype)
            check_route(k5, plan, before, what)
            if dtype == torch.bfloat16 and shape in K5_SHAPES:
                check(plan.route == "wgmma", "%s planned the %s route, not "
                      "wgmma" % (what, plan.route))
            want = ops.conv1x1_s2_dgrad_plain(dy, w2, 2 * ho, 2 * wo)
            torch.cuda.synchronize()
            tol = K5_TOL[dtype]
            err = max_err([got.float()], [want.float()], what,
                          rtol=tol, atol=tol)
            check(bool((got[:, 1::2] == 0).all())
                  and bool((got[:, :, 1::2] == 0).all()),
                  "conv1x1_s2_dgrad %s left a nonzero at an odd position"
                  % (shape,))
            row = {"shape": list(shape), "dtype": str(dtype).split(".")[1],
                   "route": plan.route, "bn": plan.bn, "grid": plan.grid,
                   "max_abs_err": err}
            if shape in K5_SHAPES:
                lib = cudnn_dgrad(dy, w2, 2 * ho, 2 * wo)
                # the yardstick must compute the same dx, to K5's tolerance
                lib_err = max_err([lib().float()], [want.float()],
                                  "cuDNN dgrad %s %s" % (shape, dtype),
                                  rtol=tol, atol=tol)
                t_bytes, t_ops = k5_times(*shape, dtype)
                bound, by = bound_of(t_bytes, t_ops)
                row.update(
                    ms=time_ms(lambda: k5(dy, w2, 2 * ho, 2 * wo), 20),
                    plain_ms=time_ms(lambda: ops.conv1x1_s2_dgrad_plain(
                        dy, w2, 2 * ho, 2 * wo), 20),
                    library_ms=time_ms(lib, 20), library_max_abs_err=lib_err,
                    bound_ms=bound, bound_by=by, bytes_ms=t_bytes,
                    operations_ms=t_ops)
                if dtype == torch.bfloat16 and shape == K5_SHAPES[1]:
                    row["identical_calls"] = check_deterministic(
                        lambda *a: [k5(*a)], (dy, w2, 2 * ho, 2 * wo), what)
            del dy, w2, got, want
            log("phase 10 conv1x1_s2_dgrad %s" % json.dumps(row))
            rows.append(row)
    return rows


def resnet_module(mx, ctx, batch, dtype):
    """The benchmark's ``build_module``: a Gluon zoo ResNet-50 v1 (NHWC),
    Xavier on ``ctx``, one eager forward to materialise the deferred
    parameters, the traced symbol under ``SoftmaxOutput``, a Module bound
    with the dtype's ``type_dict``, its parameters from the Gluon net,
    SGD with momentum 0.9."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    net = vision.get_model("resnet50_v1", classes=CLASSES, layout="NHWC")
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net(mx.nd.zeros((batch,) + IMAGE, ctx=ctx))
    sym = mx.sym.SoftmaxOutput(net._trace_symbol(), name="softmax")
    mod = mx.mod.Module(sym, context=ctx)
    type_dict = None
    if dtype != "float32":
        type_dict = {"data": dtype}
        type_dict.update({p: dtype for p in mod._param_names})
    mod.bind(data_shapes=[("data", (batch,) + IMAGE)],
             label_shapes=[("softmax_label", (batch,))], type_dict=type_dict)
    mod.init_params(initializer=mx.init.Xavier(),
                    arg_params={k: v.data()
                                for k, v in net.collect_params().items()},
                    allow_missing=True)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": RESNET_LR, "momentum": 0.9})
    return mod


def image_batches(mx, rng, ctx, n, batch, dtype):
    """n batches of uniform [0, 1) images and random labels, on ``ctx``
    (staged, as the benchmark's ``--prestack`` stages them)."""
    return [mx.io.DataBatch(
        data=[mx.nd.array(rng.rand(batch, *IMAGE).astype(np.float32),
                          ctx=ctx, dtype=dtype)],
        label=[mx.nd.array(rng.randint(0, CLASSES, batch), ctx=ctx)])
        for _ in range(n)]


def nll(probs, labels):
    """Mean negative log-likelihood of the labels (the softmax loss)."""
    p = probs.float().gather(-1, labels.long()[..., None])[..., 0]
    return (-torch.log(p.clamp_min(1e-30))).mean(-1)


def rel_err(got, want):
    """|got - want| / |want| in the Frobenius norm (0 when both are 0)."""
    num = float(np.linalg.norm(got - want))
    den = float(np.linalg.norm(want))
    return num / den if den else (0.0 if num == 0.0 else float("inf"))


def leaf_errs(got, want):
    """{name: rel_err} of two {name: array} dicts; the largest, its name
    and the median."""
    errs = {n: rel_err(got[n], w) for n, w in want.items()}
    worst = max(errs, key=errs.get)
    return {"max": errs[worst], "worst": worst,
            "median": float(np.median(list(errs.values())))}


def grads_of(mod):
    return {n: mod._exec.grad_dict[n].asnumpy() for n in mod._param_names
            if mod._exec.grad_dict.get(n) is not None}


def max_abs(got, want):
    return max(float(np.abs(g - want[n]).max()) for n, g in got.items())


def phase_resnet_check(mx, rng):
    """Part 1: f32 at batch 4, TF32 off: 2 SGD-momentum steps at the
    benchmark's lr 0.05 on gpu(0) against the same Module on cpu(), each
    from the card's weights (the CPU Module takes them before each step).
    Each step is ``_step``'s two halves: after ``forward_backward`` the
    outputs and moving statistics are held elementwise to
    RESNET_RTOL/ATOL and every parameter's gradient by relative norm to
    GRAD_REL; after ``update`` every parameter's change by relative norm
    to GRAD_REL. Two controls must fail that limit: the gradients with
    K5's dx zeroed on the card, and a second update that forgets the
    momentum. The readings are printed before they are checked."""
    batch_shape = (RESNET_CHECK_BATCH,) + IMAGE
    mod = resnet_module(mx, mx.gpu(0), RESNET_CHECK_BATCH, "float32")
    ref = mx.mod.Module(mod.symbol, context=mx.cpu())
    ref.bind(data_shapes=[("data", batch_shape)],
             label_shapes=[("softmax_label", (RESNET_CHECK_BATCH,))])
    ref.set_params(*[mx.params_to_numpy(d) for d in mod.get_params()])
    ref.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": RESNET_LR, "momentum": 0.9})
    batches = image_batches(mx, rng, mx.cpu(), 3, RESNET_CHECK_BATCH,
                            "float32")
    steps, fails = [], []
    for step, batch in enumerate(batches[:2]):
        ref.set_params(*[mx.params_to_numpy(d) for d in mod.get_params()])
        for m in (mod, ref):
            m.forward_backward(batch)
        got = mod.get_outputs()[0].asnumpy()
        want = ref.get_outputs()[0].asnumpy()
        check(got.shape == (RESNET_CHECK_BATCH, CLASSES)
              and bool(np.isfinite(got).all()),
              "ResNet step %d output not finite" % step)
        aux, aux_ref = (mx.params_to_numpy(m.get_params()[1])
                        for m in (mod, ref))
        if not np.allclose(got, want, rtol=RESNET_RTOL, atol=RESNET_ATOL):
            fails.append("step %d outputs" % step)
        fails += ["step %d moving statistic %s" % (step, n)
                  for n, v in aux_ref.items()
                  if not np.allclose(aux[n], v, rtol=RESNET_RTOL,
                                     atol=RESNET_ATOL)]
        grads, grads_ref = grads_of(mod), grads_of(ref)
        before = mx.params_to_numpy(ref.get_params()[0])
        for m in (mod, ref):
            m.update()
        moved, moved_ref = ({n: v - before[n] for n, v in
                             mx.params_to_numpy(m.get_params()[0]).items()}
                            for m in (mod, ref))
        row = {"output_max_abs_err": float(np.abs(got - want).max()),
               "moving_stat_max_abs_err": max_abs(aux, aux_ref),
               "grad_rel": leaf_errs(grads, grads_ref),
               "update_rel": leaf_errs(moved, moved_ref)}
        if step == 1:       # control: the update without the momentum term
            plain = {n: -RESNET_LR / RESNET_CHECK_BATCH * g
                     for n, g in grads.items()}
            row["control_update_without_momentum_rel"] = leaf_errs(
                plain, moved_ref)
        steps.append(row)
    # control: the gradients with every K5 dx zeroed on the card
    from mxnet_tpu_torch.ops import nn as nn_ops
    ref.set_params(*[mx.params_to_numpy(d) for d in mod.get_params()])
    k5 = nn_ops.conv1x1_s2_dgrad
    nn_ops.conv1x1_s2_dgrad = lambda dy, w2, h, w: dy.new_zeros(
        (dy.shape[0], h, w, w2.shape[1]))
    try:
        mod.forward_backward(batches[2])
    finally:
        nn_ops.conv1x1_s2_dgrad = k5
    ref.forward_backward(batches[2])
    control_k5 = leaf_errs(grads_of(mod), grads_of(ref))
    summary = {"batch": RESNET_CHECK_BATCH, "lr": RESNET_LR,
               "grad_rel_limit": GRAD_REL, "steps": steps,
               "control_k5_dx_zeroed_grad_rel": control_k5}
    log("phase 11 f32 vs cpu %s" % json.dumps(summary))
    for step, row in enumerate(steps):
        fails += ["step %d %s of %s: %.3g" % (step, kind, row[kind]["worst"],
                                              row[kind]["max"])
                  for kind in ("grad_rel", "update_rel")
                  if not row[kind]["max"] <= GRAD_REL]
    for what, reading in (
            ("K5 dx zeroed", control_k5["max"]),
            ("update without momentum",
             steps[1]["control_update_without_momentum_rel"]["max"])):
        if reading <= GRAD_REL:
            fails.append("control %s passes the limit: %.3g" % (what,
                                                                reading))
    check(not fails, "ResNet f32 card vs cpu: " + "; ".join(fails))
    return summary


def timed_steps(mod, batches):
    """``_step`` over ``batches``: (host wall s bracketed by synchronize,
    the output probabilities of every step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for b in batches:
        mod._step(b)
        outs.append(mod.get_outputs()[0].data)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, outs


def phase_resnet_train(mx, rng):
    """Part 2: bf16 batch 128, gate on: 2 warm-up steps, 10 timed
    ``_step``s and one ``_step_scan`` over 10 staged batches."""
    mod = resnet_module(mx, mx.gpu(0), RESNET_BATCH, "bfloat16")
    batches = image_batches(mx, rng, mx.gpu(0), RESNET_STEPS, RESNET_BATCH,
                            "bfloat16")
    mixed = phase_resnet_bf16_vs_f32(mx, mod, batches[:BF16_BATCHES])
    for b in batches[:RESNET_WARMUP]:
        mod._step(b)
    wall, outs = timed_steps(mod, batches)
    losses = [float(nll(o, b.label[0].data)) for o, b in zip(outs, batches)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stacked = mod._step_scan(batches)
    torch.cuda.synchronize()
    scan_wall = time.perf_counter() - t0
    labels = torch.stack([b.label[0].data for b in batches])
    scan_losses = [float(v) for v in nll(stacked[0].data, labels)]
    check(all(bool(torch.isfinite(o).all()) for o in outs)
          and bool(torch.isfinite(stacked[0].data).all())
          and all(np.isfinite(losses + scan_losses)),
          "ResNet bf16 outputs or losses not finite: %s %s"
          % (losses, scan_losses))
    steps = RESNET_WARMUP + 2 * RESNET_STEPS
    return mod, batches, steps, mixed, {
        "batch": RESNET_BATCH, "dtype": "bfloat16",
        "step_s": wall / RESNET_STEPS,
        "step_imgs_per_s": RESNET_STEPS * RESNET_BATCH / wall,
        "scan_s": scan_wall / RESNET_STEPS,
        "scan_imgs_per_s": RESNET_STEPS * RESNET_BATCH / scan_wall,
        "losses": losses, "scan_losses": scan_losses,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_resnet_gate_off(mod, batches):
    """Part 3: the same Module with ``MXNET_CONV1X1_PALLAS=0`` (cuDNN's
    dgrad for the six convs): 10 timed steps."""
    os.environ["MXNET_CONV1X1_PALLAS"] = "0"
    try:
        wall, outs = timed_steps(mod, batches)
    finally:
        os.environ["MXNET_CONV1X1_PALLAS"] = "1"
    losses = [float(nll(o, b.label[0].data)) for o, b in zip(outs, batches)]
    check(all(np.isfinite(losses)), "gate-off losses not finite")
    return {"step_s": wall / RESNET_STEPS,
            "step_imgs_per_s": RESNET_STEPS * RESNET_BATCH / wall,
            "losses": losses}


def centred_logp(probs):
    """Row-centred log-probabilities of softmax outputs, in f32."""
    lp = torch.log(probs.float().clamp_min(1e-30))
    return lp - lp.mean(-1, keepdim=True)


def phase_resnet_bf16_vs_f32(mx, mod, batches):
    """Part 4: one training-mode forward (batch statistics) of the bf16
    Module and of an f32 Module with the same weights (cast up) on each of
    ``batches``, before the bf16 Module's first step: the relative norm of
    the difference of their row-centred log-probabilities, held to
    BF16_REL. Two controls must fail that limit: the bf16 outputs at
    temperature 2, and a bf16 forward whose BatchNorm scales by 1/var."""
    from mxnet_tpu_torch.ops import nn as nn_ops
    ref = mx.mod.Module(mod.symbol, context=mx.gpu(0))
    ref.bind(data_shapes=[("data", (RESNET_BATCH,) + IMAGE)],
             label_shapes=[("softmax_label", (RESNET_BATCH,))],
             for_training=False)
    ref.init_params(arg_params=mod.get_params()[0],
                    aux_params=mod.get_params()[1])
    readings, spread_err = [], []
    for batch in batches:
        f32 = mx.io.DataBatch(data=[mx.nd.NDArray(batch.data[0].data.float(),
                                                  mx.gpu(0))],
                              label=batch.label)
        mod.forward(batch, is_train=True)
        ref.forward(f32, is_train=True)
        got = mod.get_outputs()[0].data
        check(bool(torch.isfinite(got).all()), "bf16 forward not finite")
        lp_got = centred_logp(got)
        lp_want = centred_logp(ref.get_outputs()[0].data)
        readings.append(float((lp_got - lp_want).norm() / lp_want.norm()))
        spread = lp_want.max(-1).values - lp_want.min(-1).values
        spread_err.append(float(((lp_got - lp_want).abs().max(-1).values
                                 / spread).max()))
    # controls, on the last batch
    cooled = centred_logp(torch.softmax(lp_got / 2, -1))
    control_temp = float((cooled - lp_want).norm() / lp_want.norm())
    apply = nn_ops._bn_apply
    nn_ops._bn_apply = lambda data, g, beta, mean, inv, bshape: apply(
        data, g, beta, mean, inv * inv, bshape)
    try:
        mod.forward(batch, is_train=True)
    finally:
        nn_ops._bn_apply = apply
    lp_bad = centred_logp(mod.get_outputs()[0].data)
    control_bn = float((lp_bad - lp_want).norm() / lp_want.norm())
    summary = {"batches": len(batches), "logp_rel": readings,
               "logp_rel_limit": BF16_REL,
               "logp_max_abs_err_over_spread": spread_err,
               "control_temperature_2": control_temp,
               "control_bn_inverse_var": control_bn}
    log("phase 11 bf16 vs f32 %s" % json.dumps(summary))
    check(max(readings) <= BF16_REL, "bf16 vs f32 log-probabilities differ "
          "by %.3g relative (limit %.3g)" % (max(readings), BF16_REL))
    check(not control_temp <= BF16_REL and not control_bn <= BF16_REL,
          "a bf16-vs-f32 control passes the limit %.3g: temperature %.3g, "
          "BatchNorm 1/var %.3g" % (BF16_REL, control_temp, control_bn))
    return summary


# kernel classes of a train step, by the op that launched the kernel (the
# executor's op name in forward, the autograd node in backward) and by
# the kernel's own name
def kernel_class(kernel, stack):
    k = kernel.lower()
    where = " ".join(stack)
    if "multi_tensor_kernel" in k:
        return "U1 multi_tensor_update"
    if "update" in where and ("memcpy" in k or "memset" in k):
        return "optimizer update"
    if "dgrad_wgmma" in k or "dgrad_bf16" in k or "dgrad_f32" in k:
        return "K5 conv1x1_s2_dgrad"
    if "memcpy" in k or "memset" in k:
        return "copies"
    if "op:Convolution" in where or "Convolution" in where \
            or "Conv1x1S2" in where:
        if "dgrad" in k:
            return "conv dgrad (cuDNN)"
        if "wgrad" in k:
            return "conv wgrad (cuDNN)"
        if "evaluate_function" in where and "Conv1x1S2" in where:
            return "K5 path wgrad GEMM and slice copy"
        if "evaluate_function" in where:
            return "conv backward, other"
        return "conv forward (cuDNN)"
    if "BatchNorm" in where:
        return "BatchNorm passes"
    if "Pooling" in where or "Pool" in where or "Activation" in where \
            or "Threshold" in where or "Relu" in where or "Mean" in where:
        return "pooling and activation"
    if "update" in where:
        return "optimizer update"
    if "gemm" in k or "FullyConnected" in where or "Mm" in where:
        return "classifier GEMM"
    if "copy" in k or "CopyBackwards" in where or "ToCopyBackward" in where:
        return "copies"
    return "other (softmax, residual add, loss head)"


class ranged_ops:
    """Each registered op's compute, and each method named by
    ``updates`` (``(owner, attribute)`` pairs), inside a named profiler
    range ("op:<name>", "update") while the block runs."""

    def __init__(self, updates=()):
        self._updates = updates
        self._saved = []

    def __enter__(self):
        from torch.profiler import record_function
        from mxnet_tpu_torch.ops import registry

        def ranged(name, fn):
            def run(*args, **kwargs):
                with record_function(name):
                    return fn(*args, **kwargs)
            return run
        for op in {id(op): op for op in registry._OPS.values()}.values():
            self._saved.append((op, "fcompute", op.fcompute))
            op.fcompute = ranged("op:" + op.name, op.fcompute)
        for owner, attr in self._updates:
            # a method of the class: the wrapper shadows it on the object
            own = attr in vars(owner)
            self._saved.append((owner, attr, getattr(owner, attr)
                                if own else None))
            setattr(owner, attr, ranged("update", getattr(owner, attr)))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            if fn is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)
        return False


def profiled_step(step):
    """``step`` once to warm, then once under torch.profiler: the wall
    time and the device time by kernel class (``kernel_class``), the idle
    share and the launches."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    classes = {}
    launches = 0
    update_host_ms = 0.0
    for evt in prof.events():
        if evt.name == "update":
            update_host_ms += evt.cpu_time_total / 1e3
        if not evt.kernels:
            continue
        stack, e = [], evt
        while e is not None:
            stack.append(e.name)
            e = e.cpu_parent
        for kern in evt.kernels:
            cls = classes.setdefault(kernel_class(kern.name, stack),
                                     [0, 0.0, {}])
            cls[0] += 1
            cls[1] += kern.duration / 1e3
            cls[2][kern.name[:50]] = cls[2].get(kern.name[:50], 0.0) \
                + kern.duration / 1e3
            launches += 1
    # U1's launch (from csrc's library, by ctypes) carries no CPU event in
    # this trace: take it from the device-side totals
    if "U1 multi_tensor_update" not in classes:
        for e in prof.key_averages():
            if "multi_tensor_kernel" in e.key and \
                    str(getattr(e, "device_type", "")).endswith("CUDA"):
                cls = classes.setdefault("U1 multi_tensor_update",
                                         [0, 0.0, {}])
                cls[0] += e.count
                cls[1] += e.self_device_time_total / 1e3
                cls[2][e.key[:50]] = e.self_device_time_total / 1e3
                launches += e.count
    busy = sum(ms for _, ms, _ in classes.values())
    check(launches > 0, "the profiler saw no device kernel in the step")
    return {"step_wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall, "kernels": launches,
            "update_host_ms": update_host_ms,
            "classes": {k: {"launches": c, "ms": ms, "share": ms / busy,
                            "top": sorted(names.items(),
                                          key=lambda kv: -kv[1])[:3]}
                        for k, (c, ms, names) in sorted(
                            classes.items(), key=lambda kv: -kv[1][1])}}


def phase_resnet_profile(mx, mod, batch):
    """One bf16 batch-128 step under torch.profiler, gate on, with each
    forward op and the optimizer update in a named range."""
    with ranged_ops([(mod, "update")]):
        return profiled_step(lambda: mod._step(batch))


# ---------------------------------------------------------------------------
# the attention slice: K4, the op's entry points, an attention LM through
# Module; and rtc (K6)
# ---------------------------------------------------------------------------
def attention_bound(b, tq, tk, h, d, causal, dtype):
    """(ms, "bytes" | "operations") of one attention forward: q, k, v read
    and o written once at the HBM rate, or the operations these inputs
    need at the dtype's peak, 4*D for every (query, key) pair that is not
    masked (for causal attention the pairs with kpos <= qpos)."""
    item = 2 if dtype == torch.bfloat16 else 4
    nbytes = item * b * h * d * (2 * tq + 2 * tk)
    if not causal:
        pairs = tq * tk
    elif tq <= tk:
        pairs = tq * (tq + 1) // 2
    else:
        pairs = tk * (tk + 1) // 2 + (tq - tk) * tk
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    return bound_of(nbytes / PEAK_BYTES_PER_S * 1e3,
                    4.0 * b * h * d * pairs / peak * 1e3)


def sdpa(q, k, v, causal):
    """``scaled_dot_product_attention`` on [B, H, T, D] views of the same
    inputs, back to [B, T, H, D]: the yardstick only (its causal mask is
    the top-left one too)."""
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal)
    return out.transpose(1, 2)


def sass_registers(so, kernel):
    """Registers the SASS of ``kernel`` (a substring of its symbol) in the
    library ``so`` addresses (the highest R index + 1), or None without
    cuobjdump: with setmaxnreg this is what a branch really holds, where
    ptxas reports the count at entry."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    syms = [w for w in subprocess.run(
        [tool, "-symbols", so], capture_output=True, text=True,
        timeout=60).stdout.split() if kernel in w]
    sass = subprocess.run([tool, "-sass", "-fun", syms[0], so],
                          capture_output=True, text=True, timeout=60).stdout
    return 1 + max(int(r) for r in re.findall(r"\bR(\d+)\b", sass))


def wgmma_ptxas(name, lib, kernel, key, smem):
    """The wgmma kernels of csrc/<name>.cu as ptxas built them, by their
    one template argument (``kernel`` % it is the mangled name's
    fragment; ``key`` % it the result's key): registers a thread at entry
    and as the SASS uses them, spill bytes, whether ptxas serialised
    their wgmmas, and ``smem(it)``, the dynamic shared memory of one
    block."""
    from mxnet_tpu_torch.ops import _build
    lines = (_build.build_log(name) or "").splitlines()
    pattern = re.escape(kernel).replace(re.escape("%d"), r"(\d+)")
    out = {}
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for \S*" + pattern, line)
        if not m:
            continue
        arg = int(m.group(1))
        text = " ".join(lines[i + 1:i + 3])
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", text)
        out[key % arg] = {
            "registers_at_entry": int(re.search(r"Used (\d+) registers",
                                                text).group(1)),
            "registers_used": sass_registers(lib._name, kernel % arg),
            "spill_stores": int(spill.group(1)),
            "spill_loads": int(spill.group(2)),
            "wgmma_serialized": any("C7512" in x and kernel % arg in x
                                    for x in lines),
            "smem_bytes": smem(arg)}
    check(len(out) == 2, "no ptxas report of the wgmma kernels of %s in "
          "the build log" % name)
    return out


def k4_ptxas(ops):
    """The bf16 K4 kernels by head-dim tile (``wgmma_ptxas``)."""
    lib = ops.attention_kernel._library()
    return wgmma_ptxas("flash_attention", lib, "flash_fwd_bf16ILi%dE",
                       "D<=%d", lib.flash_attention_bf16_smem)


def phase_k4(ops, device):
    """K4 against its plain version (on the last ATT_SAMPLE query rows of
    every head where the whole would not fit), with kernel, plain and
    library times and the bound."""
    rows = []
    for n, (b, tq, tk, h, d, causal, dtype) in enumerate(K4_CASES):
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + 40 + n)
        q, k, v = (torch.randn((b, t, h, d), generator=gen, device=device)
                   .to(dtype) for t in (tq, tk, tk))
        got = ops.flash_attention(q, k, v, causal=causal)
        start = max(0, tq - ATT_SAMPLE) if tq > ATT_FULL_ROWS else 0

        def plain(start=start):
            return ops.flash_attention_plain(q[:, start:], k, v,
                                             causal=causal, q_start=start)
        want = plain()
        torch.cuda.synchronize()
        rtol, atol = K4_TOL[dtype]
        err = max_err([got[:, start:].float()], [want.float()],
                      "flash_attention %s" % ((b, tq, tk, h, d, causal,
                                               str(dtype)),),
                      rtol=rtol, atol=atol)
        lib = sdpa(q, k, v, causal)
        bound, by = attention_bound(b, tq, tk, h, d, causal, dtype)
        # TFLOP/s as tools/perf/attention_bench.py counts them
        flops = 4.0 * b * h * tq * tk * d * (0.5 if causal else 1.0)
        ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=causal), 20)
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
        row = {"B": b, "Tq": tq, "Tk": tk, "H": h, "D": d, "causal": causal,
               "dtype": str(dtype).split(".")[1], "max_abs_err": err,
               "checked_rows": tq - start, "ms": ms,
               "tflops": flops / ms / 1e9,
               "peak_share": flops / ms * 1e3 / peak,
               "bound_ms": bound, "bound_by": by,
               "plain_ms": time_ms(plain, 5),
               "library_ms": time_ms(lambda: sdpa(q, k, v, causal), 20),
               "library_max_abs_err": float(
                   (lib[:, start:].float() - want.float()).abs().max())}
        del q, k, v, got, want, lib
        torch.cuda.empty_cache()
        log("phase 13 flash_attention %s" % json.dumps(row))
        rows.append(row)
    return rows


def phase_attention_op(mx, ops):
    """``nd.contrib.flash_attention`` on gpu NDArrays, and
    ``sym.contrib.flash_attention`` bound by an executor on gpu(0):
    forward and the q, k, v gradients against the dense version's
    autograd, f32."""
    b, t, h, d = 2, 256, 4, 64
    rng = np.random.RandomState(SEED + 50)
    arrays = [rng.randn(b, t, h, d).astype(np.float32) for _ in range(3)]
    cot = rng.randn(b, t, h, d).astype(np.float32)
    ctx = mx.gpu(0)
    launches = ops.flash_attention.launches
    out = mx.nd.contrib.flash_attention(
        *[mx.nd.array(a, ctx=ctx) for a in arrays], causal=True)
    qkv = [torch.from_numpy(a).to(ctx.torch_device()).requires_grad_(True)
           for a in arrays]
    want = ops.flash_attention_plain(*qkv, causal=True)
    err_nd = max_err([out.data], [want.detach()], "nd.contrib.flash_attention",
                     rtol=2e-5, atol=2e-5)
    q, k, v = (mx.sym.var(n) for n in "qkv")
    sym = mx.sym.contrib.flash_attention(q, k, v, causal=True, name="att")
    ex = sym.simple_bind(ctx, grad_req="write",
                         **{n: a.shape for n, a in zip("qkv", arrays)})
    for n, a in zip("qkv", arrays):
        ex.arg_dict[n][:] = a
    ex.forward(is_train=True)
    ex.backward(mx.nd.array(cot, ctx=ctx))
    dense = ops.dense_attention_plain(*qkv, causal=True)
    grads = torch.autograd.grad(dense, qkv, torch.from_numpy(cot).to(
        ctx.torch_device()))
    err_fwd = max_err([ex.outputs[0].data], [want.detach()],
                      "sym.contrib.flash_attention", rtol=2e-5, atol=2e-5)
    err_grad = max_err([ex.grad_dict[n].data for n in "qkv"], list(grads),
                       "sym.contrib.flash_attention gradients", rtol=1e-4,
                       atol=1e-4)
    launched = ops.flash_attention.launches - launches
    check(launched == 2, "the op's two entry points launched "
          "flash_attention %d times, want 2" % launched)
    return {"shape": [b, t, h, d], "nd_max_abs_err": err_nd,
            "executor_max_abs_err": err_fwd,
            "executor_grad_max_abs_err": err_grad, "launches": launched}


def attention_lm(mx, seq):
    """The long-context example's causal LM as a graph, at the attention
    bench's widths: pre-norm blocks of causal attention and a relu MLP
    with residual adds, no biases (LayerNorm and relu stand in for the
    example's RMS norm and gelu), data (1, T) token ids, labels (T,)."""
    sym = mx.sym
    x = sym.Embedding(sym.var("data"), input_dim=ATT_VOCAB,
                      output_dim=ATT_EMBED, name="embed")
    for i in range(ATT_LAYERS):
        hid = sym.LayerNorm(x, name="ln%d_att" % i)
        q, k, v = (sym.Reshape(sym.FullyConnected(
            hid, num_hidden=ATT_EMBED, flatten=False, no_bias=True,
            name="%s%d" % (n, i)),
            shape=(0, 0, ATT_HEADS, ATT_EMBED // ATT_HEADS)) for n in "qkv")
        att = sym.contrib.flash_attention(q, k, v, causal=True,
                                          name="att%d" % i)
        att = sym.FullyConnected(sym.Reshape(att, shape=(0, 0, -1)),
                                 num_hidden=ATT_EMBED, flatten=False,
                                 no_bias=True, name="proj%d" % i)
        x = sym.elemwise_add(x, att, name="res%d_att" % i)
        hid = sym.LayerNorm(x, name="ln%d_mlp" % i)
        hid = sym.Activation(sym.FullyConnected(
            hid, num_hidden=4 * ATT_EMBED, flatten=False, no_bias=True,
            name="mlp%d_in" % i), act_type="relu", name="relu%d" % i)
        hid = sym.FullyConnected(hid, num_hidden=ATT_EMBED, flatten=False,
                                 no_bias=True, name="mlp%d_out" % i)
        x = sym.elemwise_add(x, hid, name="res%d_mlp" % i)
    logits = sym.FullyConnected(x, num_hidden=ATT_VOCAB, flatten=False,
                                no_bias=True, name="head")
    return sym.SoftmaxOutput(sym.Reshape(logits, shape=(-1, ATT_VOCAB)),
                             normalization="valid", name="softmax")


def attention_module(mx, ctx, seq, dtype):
    """bind (the dtype's ``type_dict`` on every parameter), Xavier from
    ``mx.random.seed``, SGD lr 0.05 momentum 0.9."""
    mod = mx.mod.Module(attention_lm(mx, seq), context=ctx)
    type_dict = None
    if dtype != "float32":
        type_dict = {p: dtype for p in mod._param_names}
    mod.bind(data_shapes=[("data", (1, seq))],
             label_shapes=[("softmax_label", (seq,))], type_dict=type_dict)
    mx.random.seed(SEED)
    mod.init_params(initializer=mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=ATT_OPT)
    return mod


def token_batches(mx, rng, ctx, n, seq):
    """n batches of the example's synthetic sequences (each token the one
    before it plus 1, mod the vocabulary, from a random start), with the
    next tokens as labels, on ``ctx``."""
    batches = []
    for _ in range(n):
        toks = (rng.randint(0, ATT_VOCAB) + np.arange(seq + 1)) % ATT_VOCAB
        batches.append(mx.io.DataBatch(
            data=[mx.nd.array(toks[None, :seq], ctx=ctx)],
            label=[mx.nd.array(toks[1:], ctx=ctx)]))
    return batches


def phase_attention_check(mx, ops, rng):
    """Part 1: f32 at T=ATT_CHECK_SEQ, TF32 off: 2 SGD-momentum steps on
    gpu(0) against the same Module on cpu(), each from the card's
    weights, as phase 11 holds ResNet-50: outputs elementwise, every
    parameter's gradient and update by relative norm to ATT_GRAD_REL;
    two controls must fail that limit (K4's output zeroed on the card;
    a second update without the momentum)."""
    seq = ATT_CHECK_SEQ
    mod = attention_module(mx, mx.gpu(0), seq, "float32")
    ref = mx.mod.Module(mod.symbol, context=mx.cpu())
    ref.bind(data_shapes=[("data", (1, seq))],
             label_shapes=[("softmax_label", (seq,))])
    ref.set_params(*[mx.params_to_numpy(d) for d in mod.get_params()])
    ref.init_optimizer(optimizer="sgd", optimizer_params=ATT_OPT)
    batches = token_batches(mx, rng, mx.cpu(), 3, seq)
    steps, fails = [], []
    for step, batch in enumerate(batches[:2]):
        ref.set_params(*[mx.params_to_numpy(d) for d in mod.get_params()])
        for m in (mod, ref):
            m.forward_backward(batch)
        got = mod.get_outputs()[0].asnumpy()
        want = ref.get_outputs()[0].asnumpy()
        check(got.shape == (seq, ATT_VOCAB) and bool(np.isfinite(got).all()),
              "attention LM step %d output not finite" % step)
        if not np.allclose(got, want, rtol=ATT_RTOL, atol=ATT_ATOL):
            fails.append("step %d outputs (max abs err %.3g)"
                         % (step, float(np.abs(got - want).max())))
        grads, grads_ref = grads_of(mod), grads_of(ref)
        before = mx.params_to_numpy(ref.get_params()[0])
        for m in (mod, ref):
            m.update()
        moved, moved_ref = ({n: v - before[n] for n, v in
                             mx.params_to_numpy(m.get_params()[0]).items()}
                            for m in (mod, ref))
        row = {"output_max_abs_err": float(np.abs(got - want).max()),
               "grad_rel": leaf_errs(grads, grads_ref),
               "update_rel": leaf_errs(moved, moved_ref)}
        if step == 1:
            plain = {n: -ATT_OPT["learning_rate"] * g
                     for n, g in grads.items()}
            row["control_update_without_momentum_rel"] = leaf_errs(
                plain, moved_ref)
        steps.append(row)
    from mxnet_tpu_torch.ops import attention_kernel
    ref.set_params(*[mx.params_to_numpy(d) for d in mod.get_params()])
    k4 = attention_kernel.flash_attention
    attention_kernel.flash_attention = lambda q, *a, **kw: torch.zeros_like(q)
    try:
        mod.forward_backward(batches[2])
    finally:
        attention_kernel.flash_attention = k4
    ref.forward_backward(batches[2])
    control_k4 = leaf_errs(grads_of(mod), grads_of(ref))
    summary = {"seq": seq, "grad_rel_limit": ATT_GRAD_REL, "steps": steps,
               "control_k4_zeroed_grad_rel": control_k4}
    log("phase 15 f32 vs cpu %s" % json.dumps(summary))
    for step, row in enumerate(steps):
        fails += ["step %d %s of %s: %.3g" % (step, kind, row[kind]["worst"],
                                              row[kind]["max"])
                  for kind in ("grad_rel", "update_rel")
                  if not row[kind]["max"] <= ATT_GRAD_REL]
    for what, reading in (
            ("K4 output zeroed", control_k4["max"]),
            ("update without momentum",
             steps[1]["control_update_without_momentum_rel"]["max"])):
        if reading <= ATT_GRAD_REL:
            fails.append("control %s passes the limit: %.3g"
                         % (what, reading))
    check(not fails, "attention LM f32 card vs cpu: " + "; ".join(fails))
    return summary


def phase_attention_train(mx, rng):
    """Part 2: bf16 at T=ATT_SEQ: 2 warm-up and ATT_STEPS timed ``_step``s
    (tokens/s), then one profiled step."""
    mod = attention_module(mx, mx.gpu(0), ATT_SEQ, "bfloat16")
    batches = token_batches(mx, rng, mx.gpu(0), ATT_STEPS, ATT_SEQ)
    for b in batches[:ATT_WARMUP]:
        mod._step(b)
    wall, outs = timed_steps(mod, batches)
    losses = [float(nll(o, b.label[0].data)) for o, b in zip(outs, batches)]
    check(all(bool(torch.isfinite(o.float()).all()) for o in outs)
          and all(np.isfinite(losses)) and losses[-1] < losses[0],
          "attention LM bf16 outputs or losses not finite, or the loss "
          "did not fall: %s" % losses)
    return mod, batches, {
        "seq": ATT_SEQ, "dtype": "bfloat16", "step_s": wall / ATT_STEPS,
        "tokens_per_s": ATT_STEPS * ATT_SEQ / wall, "losses": losses,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_attention_profile(mod, batch):
    """One bf16 step under torch.profiler: the wall, the device's busy
    time and idle share, K4's share and the top kernels."""
    wall, kernels = device_profile(lambda: mod._step(batch))
    busy = sum(ms for _, ms in kernels.values())
    check(busy > 0, "the profiler saw no device kernel in the step")
    k4 = sum(ms for name, (_, ms) in kernels.items()
             if "flash_fwd" in name)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    return {"step_wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall, "k4_ms": k4,
            "k4_share": k4 / busy,
            "kernels": sum(c for c, _ in kernels.values()),
            "top_kernels": [{"kernel": k, "launches": c, "ms": ms,
                             "share": ms / busy} for k, (c, ms) in top]}


RTC_SOURCE = r'''
extern "C" __global__ void axpy(const float* x, const float* y, float* out,
                                int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = 2.0f * x[i] + y[i];
}
template <typename T>
__global__ void row_sum(const T* x, int cols, T* out) {
  extern __shared__ float buf[];
  float s = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x)
    s += static_cast<float>(x[static_cast<size_t>(blockIdx.x) * cols + c]);
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = static_cast<T>(buf[0]);
}
'''


def phase_rtc(mx):
    """K6: the user's path of ``mx.rtc`` on gpu(0) (compile, get the
    kernels, launch each once, launches counted), checked against
    ``2*x + y`` (exactly) and ``x.sum(1)``; then axpy at RTC_N timed
    against its bound, its plain PyTorch version and ``torch.add``."""
    ctx = mx.gpu(0)
    rng = np.random.RandomState(SEED + 60)
    x = mx.nd.array(rng.randn(RTC_N).astype(np.float32), ctx=ctx)
    y = mx.nd.array(rng.randn(RTC_N).astype(np.float32), ctx=ctx)
    out = mx.nd.zeros((RTC_N,), ctx=ctx)
    m = mx.nd.array(rng.randn(*RTC_ROWS).astype(np.float32), ctx=ctx)
    grid = ((RTC_N + 255) // 256,)
    t0 = time.perf_counter()
    mx.rtc.Kernel.launches = 0                # the rtc path starts here
    mod = mx.rtc.CudaModule(RTC_SOURCE, exports=["axpy", "row_sum<float>"])
    compile_s = time.perf_counter() - t0
    axpy = mod.get_kernel("axpy", "const float *x, const float *y, "
                                  "float *out, int n")
    rows = mod.get_kernel("row_sum<float>",
                          "const float *x, int cols, float *out")
    axpy.launch((x, y, out, RTC_N), ctx, grid, (256,))
    sums = rows.launch((m, RTC_ROWS[1]), ctx, (RTC_ROWS[0],), (256,),
                       shared_mem=256 * 4,
                       out_shapes=[((RTC_ROWS[0],), "float32")])
    torch.cuda.synchronize()
    launches = mx.rtc.Kernel.launches         # ... and ends here
    check(launches == 2, "the rtc path launched %d kernels, want 2"
          % launches)
    want = 2 * x.data + y.data
    check(torch.equal(out.data, want), "rtc axpy differs from 2*x+y (max "
          "abs err %.3g)" % float((out.data - want).abs().max()))
    err_sum = max_err([sums.data], [m.data.sum(1)], "rtc row_sum",
                      rtol=1e-5, atol=1e-4)
    bound = 12.0 * RTC_N / PEAK_BYTES_PER_S * 1e3
    return launches, {
        "n": RTC_N, "compile_s": compile_s, "launches": launches,
        "axpy_max_abs_err": 0.0, "row_sum_max_abs_err": err_sum,
        "ms": time_ms(lambda: axpy.launch((x, y, out, RTC_N), ctx, grid,
                                          (256,)), 20),
        "plain_ms": time_ms(lambda: 2 * x.data + y.data, 20),
        "library_ms": time_ms(lambda: torch.add(y.data, x.data, alpha=2),
                              20),
        "bound_ms": bound, "bound_by": "bytes"}


# ---------------------------------------------------------------------------
# the inference slice: nd.random, and ResNet-50 v1 through hybridize
# (compiled.py: one CUDA graph per input signature)
# ---------------------------------------------------------------------------
def phase_random(mx):
    """``nd.random`` on gpu(0): each sampler's draws lie on the card and
    meet their moments at tests/test_random.py's tolerances; one seed
    reproduces a draw bit for bit, and two draws without a reseed
    differ."""
    ctx, n = mx.gpu(0), (RANDOM_N,)
    r = mx.nd.random
    probs = mx.nd.array(np.array([[0.1, 0.2, 0.7]], "f"), ctx=ctx)
    samplers = {
        "uniform": (lambda: r.uniform(2.0, 4.0, shape=n),
                    lambda x: (2.0 <= x.min() and x.max() <= 4.0
                               and abs(x.mean() - 3.0) <= 0.05
                               and abs(x.var() - 4.0 / 12.0) <= 0.05)),
        "normal": (lambda: r.normal(1.5, 2.0, shape=n),
                   lambda x: (abs(x.mean() - 1.5) <= 0.06
                              and abs(x.std() - 2.0) <= 0.06)),
        "gamma": (lambda: r.gamma(4.0, 0.5, shape=n),
                  lambda x: abs(x.mean() - 2.0) <= 0.1),
        "poisson": (lambda: r.poisson(3.0, shape=n),
                    lambda x: abs(x.mean() - 3.0) <= 0.15),
        "exponential": (lambda: r.exponential(2.0, shape=n),
                        lambda x: abs(x.mean() - 2.0) <= 0.1),
        "negative_binomial": (lambda: r.negative_binomial(4, 0.5, shape=n),
                              lambda x: abs(x.mean() - 4.0) <= 0.2),
        "generalized_negative_binomial": (
            lambda: r.generalized_negative_binomial(3.0, 0.5, shape=n),
            lambda x: abs(x.mean() - 3.0) <= 0.15),
        "randint": (lambda: r.randint(0, 10, shape=n),
                    lambda x: x.min() == 0 and x.max() == 9),
        "multinomial": (lambda: r.multinomial(probs, shape=n),
                        lambda x: np.allclose(
                            np.bincount(x.ravel(), minlength=3) / x.size,
                            [0.1, 0.2, 0.7], atol=0.02)),
        "shuffle": (lambda: r.shuffle(mx.nd.array(np.arange(50, dtype="f"),
                                                  ctx=ctx)),
                    lambda x: sorted(x.tolist()) == list(range(50))
                    and not np.array_equal(x, np.arange(50))),
    }
    rows, fails = {}, []
    for name, (draw, ok) in samplers.items():
        mx.random.seed(SEED + 70)
        a = draw()
        mx.random.seed(SEED + 70)
        b = draw()
        c = draw()
        x = a.asnumpy()
        rows[name] = {"mean": float(x.mean()), "std": float(x.std()),
                      "device": str(a.data.device)}
        if a.data.device.type != "cuda":
            fails.append("%s drew on %s" % (name, a.data.device))
        if not ok(x):
            fails.append("%s moments %s" % (name, rows[name]))
        if not torch.equal(a.data, b.data) or torch.equal(a.data, c.data):
            fails.append("%s: a seed does not reproduce the draw, or two "
                         "draws agree" % name)
    check(not fails, "nd.random on the card: " + "; ".join(fails))
    return rows


def resnet_macs(net, shape):
    """Multiply-accumulates of one forward of a Gluon net over ``shape``:
    every Convolution (output elements x input channels a group x the
    window) and FullyConnected, from the traced symbol's shapes."""
    sym = net._trace_symbol()
    internals = sym.get_internals()
    args = dict(zip(sym.list_arguments(), sym.infer_shape(data=shape)[0]))
    outs = dict(zip(internals.list_outputs(),
                    internals.infer_shape(data=shape)[1]))
    macs = 0
    for node in sym._topo_nodes():
        if node.op not in ("Convolution", "FullyConnected"):
            continue
        weight = args[node.inputs[1][0].name]
        macs += int(np.prod(outs["%s_output" % node.name])) \
            * int(np.prod(weight[1:]))
    return macs


def call_profile(fn):
    """One call of ``fn`` under torch.profiler: profiled wall ms, device
    busy ms (kernels and copies; None if the trace held no device
    activity), device events, the host's CUDA runtime calls by name and
    the eight longest kernels (launches, device ms)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, events, api, kernels = 0.0, 0, {}, {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            busy += e.self_device_time_total / 1e3
            events += e.count
            row = kernels.setdefault(e.key[:60], [0, 0.0])
            row[0] += e.count
            row[1] += e.self_device_time_total / 1e3
        elif e.key.startswith("cuda"):
            api[e.key] = e.count
    return {"wall_ms": wall, "device_busy_ms": busy if events else None,
            "device_idle_share": 1 - busy / wall if events else None,
            "device_events": events, "runtime_calls": api,
            "top": sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]}


def infer_net(mx, layout, ctx, **extra):
    """``bench.py``'s inference set-up on the port, line for line
    (bench.py:123-146; the card in place of the TPU)."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    kwargs = {"layout": layout} if layout != "NCHW" else {}
    net = vision.resnet50_v1(**kwargs, **extra)
    net.initialize(ctx=ctx)
    return net


def infer_shape(layout, batch):
    return (batch, 3, 224, 224) if layout == "NCHW" else (batch, 224, 224, 3)


def phase_infer(mx, layout):
    """ResNet-50 v1 at batch 32, f32, TF32 off, one layout: bench.py's
    flow (initialize, hybridize, nd.random.uniform, a warm call,
    ``_cached_jit`` over ``_param_order``); the hybridized logits against
    the eager ones on the card and on ``cpu()`` (batch 4) and a control
    that must fail INFER_REL; compile counts (one compile, the timed
    calls all cache hits, one retrace at batch 16 naming dim 0);
    ``warmup()`` leaving every moving statistic bit-identical, then one
    train-mode call stepping them once, as the eager call does; a capture
    that must fail; a profile of one hybridized and one eager call, with
    cuDNN's TF32 off and on (a retrace naming the switch), the TF32-on
    graph's logits against the TF32-on eager ones to INFER_REL."""
    from mxnet_tpu_torch import compiled
    from mxnet_tpu_torch.gluon.block import HybridBlock
    ctx = mx.gpu(0)
    torch.cuda.reset_peak_memory_stats()
    mx.random.seed(SEED + 80)
    net = infer_net(mx, layout, ctx)
    x = mx.nd.random.uniform(shape=infer_shape(layout, INFER_BATCH),
                             ctx=ctx)
    eager = net(x).data.clone()             # finishes deferred init
    net.hybridize()
    before = compiled.compile_counts()
    hybrid = net(x).asnumpy()
    cached = net._cached_jit
    params = tuple(net.collect_params()[n].data()._data
                   for n in net._param_order)
    first = compiled.compile_counts()
    n_timed = 20
    for _ in range(n_timed):
        out = cached(params, 0, False, x.data)[0][0]
    timed = compiled.compile_counts()
    counts = {"first_call": {k: first[k] - before[k] for k in first},
              "timed_calls": {k: timed[k] - first[k] for k in timed}}
    check(counts["first_call"] == {"compiles": 1, "cache_hits": 0,
                                   "retraces": 0, "uncaptured": 0}
          and counts["timed_calls"] == {"compiles": 0,
                                        "cache_hits": n_timed,
                                        "retraces": 0, "uncaptured": 0},
          "%s compile counts %s: want one compile, then %d cache hits"
          % (layout, counts, n_timed))
    check(hybrid.shape == (INFER_BATCH, CLASSES)
          and bool(np.isfinite(hybrid).all())
          and torch.equal(out, torch.from_numpy(hybrid).to(out.device)),
          "%s hybridized output not finite, or replays differ" % layout)
    # the same weights on the CPU, eager, batch 4
    cpu_net = infer_net(mx, layout, mx.cpu(), prefix=net.prefix)
    mx.set_block_params(cpu_net, mx.params_to_numpy(
        {k: v.data() for k, v in net.collect_params().items()}))
    x_cpu = mx.nd.array(x.asnumpy()[:INFER_CHECK_BATCH], ctx=mx.cpu())
    on_cpu = cpu_net(x_cpu).asnumpy()
    want = eager.cpu().numpy()
    readings = {"vs_eager_on_card": rel_err(hybrid, want),
                "vs_eager_on_cpu": rel_err(hybrid[:INFER_CHECK_BATCH],
                                           on_cpu),
                "eager_card_vs_cpu": rel_err(want[:INFER_CHECK_BATCH],
                                             on_cpu),
                "max_abs_err_vs_eager_on_card": float(
                    np.abs(hybrid - want).max())}
    # control: one stage-3 BatchNorm's moving variance doubled, in place,
    # so the graph reads it without a recapture
    var = next(net.collect_params()[n].data().data for n in net._param_order
               if "stage3" in n and n.endswith("running_var"))
    var.mul_(2)
    control = net(x).asnumpy()
    var.div_(2)
    readings["control_bn_var_doubled"] = rel_err(control, want)
    check(np.array_equal(net(x).asnumpy(), hybrid),
          "%s: the hybridized output changed after the control" % layout)
    # one retrace at batch 16, naming the batch dimension
    small = mx.nd.random.uniform(
        shape=infer_shape(layout, INFER_RETRACE_BATCH), ctx=ctx)
    before = compiled.compile_counts()
    net(small)
    after = compiled.compile_counts()
    retrace = compiled.last_retrace()
    check(after["retraces"] - before["retraces"] == 1
          and after["compiles"] - before["compiles"] == 1
          and "dim 0: %d -> %d" % (INFER_BATCH, INFER_RETRACE_BATCH)
          in retrace["reason"],
          "%s batch %d: counts %s -> %s, retrace %s" % (
              layout, INFER_RETRACE_BATCH, before, after, retrace))
    # warmup() changes no moving statistic; one train-mode call steps
    # them once, as the eager call does from the same state
    stats = {n: net.collect_params()[n].data().data
             for n in net._param_order if "running" in n}
    saved = {n: v.clone() for n, v in stats.items()}
    cached.warmup(params, 0, True, x.data)
    check(all(torch.equal(v, saved[n]) for n, v in stats.items()),
          "%s: warmup() changed a moving statistic" % layout)
    with mx.autograd.train_mode():
        train_out = net(x).data.clone()
    stepped = {n: v.clone() for n, v in stats.items()}
    for n, v in stats.items():
        v.copy_(saved[n])
    net.hybridize(False)
    with mx.autograd.train_mode():
        train_eager = net(x).data.clone()
    net.hybridize()
    stat_err = max(float((stepped[n] - v).abs().max())
                   for n, v in stats.items())
    moved = sum(not torch.equal(stepped[n], saved[n]) for n in stats)
    readings.update(train_mode_vs_eager=rel_err(
        train_out.cpu().numpy(), train_eager.cpu().numpy()),
        train_mode_moving_stat_max_abs_err=stat_err,
        moving_stats_moved=moved, moving_stats=len(stats))
    log("phase 18 %s readings %s" % (layout, json.dumps(readings)))
    fails = [k for k in ("vs_eager_on_card", "vs_eager_on_cpu",
                         "train_mode_vs_eager")
             if not readings[k] <= INFER_REL]
    if readings["control_bn_var_doubled"] <= INFER_REL:
        fails.append("the control passes the limit")
    if moved != len(stats) or not stat_err <= RESNET_ATOL + RESNET_RTOL * max(
            float(v.abs().max()) for v in stepped.values()):
        fails.append("train-mode moving statistics (%d of %d moved, max "
                     "abs err %.3g)" % (moved, len(stats), stat_err))
    check(not fails, "%s hybridized inference (limit %.3g): %s"
          % (layout, INFER_REL, "; ".join(fails)))
    # a capture that must fail raises, and nothing runs eagerly instead
    class HostSyncBlock(HybridBlock):
        """Reads a value to the host in its forward: no CUDA graph can
        hold that."""

        def hybrid_forward(self, F, v):
            v.asnumpy()
            return F.Activation(v, act_type="relu")
    sync = HostSyncBlock()
    sync.hybridize()
    try:
        sync(x)
        raised = None
    except mx.MXNetError as exc:
        raised = str(exc)
    check(raised is not None and "CUDA graph capture failed" in raised,
          "a capture holding asnumpy() did not raise MXNetError: %s"
          % raised)
    # one hybridized call and one eager call under the profiler
    net(x)
    prof_hybrid = call_profile(lambda: net(x))
    net.hybridize(False)
    net(x)
    prof_eager = call_profile(lambda: net(x))
    net.hybridize()
    # the same with cuDNN's TF32 on: a new signature (the capture keeps
    # the kernels chosen at capture time), one retrace naming the switch
    # the TF32-on graph (the one the timed rates replay) against the eager
    # call under TF32: the same kernels, so held to INFER_REL; against the
    # f32 CPU net it is only recorded, to show whether INFER_REL would
    # catch TF32's lower precision
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_hybrid = net(x).asnumpy()
        tf32_retrace = compiled.last_retrace()["reason"]
        prof_tf32 = call_profile(lambda: net(x))
        net.hybridize(False)
        tf32_eager = net(x).asnumpy()
        prof_tf32_eager = call_profile(lambda: net(x))
        net.hybridize()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    tf32_readings = {
        "tf32_vs_eager_tf32_on_card": rel_err(tf32_hybrid, tf32_eager),
        "tf32_vs_eager_on_cpu": rel_err(tf32_hybrid[:INFER_CHECK_BATCH],
                                        on_cpu)}
    tf32_readings["tf32_vs_eager_on_cpu_within_limit"] = \
        tf32_readings["tf32_vs_eager_on_cpu"] <= INFER_REL
    readings.update(tf32_readings)
    log("phase 18 %s TF32-on readings %s" % (layout,
                                             json.dumps(tf32_readings)))
    check(tf32_retrace.startswith("tf32 (cudnn, matmul)"),
          "%s: turning TF32 on gave the retrace %r" % (layout, tf32_retrace))
    check(tf32_readings["tf32_vs_eager_tf32_on_card"] <= INFER_REL,
          "%s: the TF32-on graph against the TF32-on eager call: %.3g > "
          "%.3g" % (layout, tf32_readings["tf32_vs_eager_tf32_on_card"],
                    INFER_REL))
    for prof in (prof_hybrid, prof_tf32):
        calls = prof["runtime_calls"]
        check(calls.get("cudaGraphLaunch") == 1
              and not any("LaunchKernel" in k for k in calls),
              "%s: a hybridized call made host calls %s, want one "
              "cudaGraphLaunch and no kernel launch" % (layout, calls))
    return {"layout": layout, "batch": INFER_BATCH, "readings": readings,
            "limit": INFER_REL, "compile_counts": counts,
            "retrace": retrace["reason"][:200],
            "capture_error": str(raised)[:200],
            "profile_hybridized": prof_hybrid, "profile_eager": prof_eager,
            "profile_hybridized_tf32": prof_tf32,
            "profile_eager_tf32": prof_tf32_eager,
            "macs_per_image": resnet_macs(
                net, infer_shape(layout, 1)),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_infer_rate(mx, layout, tf32):
    """img/s of the bench's own inference function, hybridized and eager,
    with cuDNN's TF32 on (PyTorch's default) or off; the hybridized run's
    counts: one compile (its warm call), every timed call a cache hit."""
    from mxnet_tpu_torch import compiled
    from mxnet_tpu_torch.tools import bench
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        rows = {}
        for hybridize in (True, False):
            before = compiled.compile_counts()
            rows["hybridized" if hybridize else "eager"] = bench.bench_infer(
                batch=INFER_BATCH, iters=INFER_ITERS, calls=INFER_CALLS,
                ctx=mx.gpu(0), layout=layout, hybridize=hybridize,
                rounds=INFER_ROUNDS)
            after = compiled.compile_counts()
            if hybridize:
                calls = INFER_ITERS * (1 + INFER_CALLS * INFER_ROUNDS)
                diff = {k: after[k] - before[k] for k in after}
                check(diff == {"compiles": 1, "cache_hits": calls,
                               "retraces": 0, "uncaptured": 0},
                      "bench run %s: counts %s, want 1 compile and %d "
                      "hits" % (layout, diff, calls))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return rows


# ---------------------------------------------------------------------------
# the Gluon training slice: the autograd tape, a hybridized call under
# record(), Trainer and the loss, with K5 under the tape
# ---------------------------------------------------------------------------
def gluon_shape(layout, batch):
    h, w, c = IMAGE
    return (batch, c, h, w) if layout == "NCHW" else (batch, h, w, c)


def gluon_net(mx, ctx, layout, **extra):
    """The example's net: ``vision.resnet50_v1(classes=1000)`` with
    Xavier(magnitude=2) on ``ctx``."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    kwargs = {"layout": layout} if layout != "NCHW" else {}
    net = vision.resnet50_v1(classes=CLASSES, **kwargs, **extra)
    net.initialize(mx.init.Xavier(magnitude=2), ctx=ctx)
    return net


def gluon_trainer(mx, net, opt=GLUON_OPT, name="sgd"):
    return mx.gluon.Trainer(net.collect_params(), name, dict(opt),
                            kvstore="device")


def gluon_record(mx, net, loss_fn, x, y):
    """``with autograd.record(): loss = loss_fn(net(x), y)`` and
    ``loss.backward()``: (outputs, losses)."""
    with mx.autograd.record():
        out = net(x)
        loss = loss_fn(out, y)
    loss.backward()
    return out, loss


def gluon_grads(net):
    return {n: p.grad().asnumpy() for n, p in net.collect_params().items()
            if p.grad_req != "null"}


def gluon_values(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def bias_noise(grads):
    """{conv bias: |its gradient| / |its conv weight's gradient|}. In
    ResNet v1 every convolution with a bias feeds a BatchNorm, which
    subtracts the batch mean: the bias's exact gradient is 0, and what is
    computed is rounding noise, which no relative norm can hold."""
    return {n: float(np.linalg.norm(g) / np.linalg.norm(
        grads[n[:-len("bias")] + "weight"]))
        for n, g in grads.items() if "_conv" in n and n.endswith("_bias")}


def phase_gluon_check(mx, rng, opt_name="sgd", opt=GLUON_CHECK_OPT,
                      tag="phase 19"):
    """Part 1: f32 at batch 4, NHWC, the gate on, TF32 off: 2 steps of the
    example's loop on gpu(0) against the same on cpu(), each from the
    card's weights (the CPU net takes them, moving statistics included,
    before each step), with the optimizer ``opt_name`` at ``opt``. After
    ``loss.backward()`` the output
    probabilities, losses and moving statistics are held elementwise to
    RESNET_RTOL/ATOL and every parameter's gradient by relative norm to
    GRAD_REL; after ``trainer.step`` every parameter's change by relative
    norm to GRAD_REL (with Adam, the CPU steps from the card's gradients
    and optimizer states: ``feed_host``). The convolutions' biases, whose
    exact gradient is 0
    (``bias_noise``), are held instead to gradients below BIAS_NOISE of
    their weights' on both sides. Controls must fail GRAD_REL: the
    gradients with K5's dx zeroed on the card; for SGD a second update
    that forgets the momentum; for Adam a third step whose update on the
    card skips the bias correction. The readings are printed before they
    are checked."""
    from mxnet_tpu_torch.ops import nn as nn_ops
    shape = gluon_shape("NHWC", GLUON_CHECK_BATCH)
    card = gluon_net(mx, mx.gpu(0), "NHWC")
    card(mx.nd.zeros(shape, ctx=mx.gpu(0)))    # finishes deferred init
    host = gluon_net(mx, mx.cpu(), "NHWC", prefix=card.prefix)
    host(mx.nd.zeros(shape, ctx=mx.cpu()))
    for net in (card, host):
        net.hybridize()
    trainers = [gluon_trainer(mx, n, opt, opt_name) for n in (card, host)]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    data = [(rng.rand(*shape).astype(np.float32),
             rng.randint(0, CLASSES, GLUON_CHECK_BATCH).astype(np.float32))
            for _ in range(3)]

    def sync_host():
        mx.set_block_params(host, gluon_values(card))

    def arrays(ctx, x, y):
        return mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)

    def feed_host():
        """Adam: the CPU steps from the card's gradients and states. An
        Adam update is about lr * sign(g) elementwise, so where the two
        packages' gradients differ by rounding on elements near 0 it flips
        sign: stepped from its own gradients the CPU's updates read 0.50
        and 0.26 by relative norm (H100 80GB HBM3, 700 W) where the
        gradients agree to 0.088."""
        host_params = host.collect_params()
        for n, p in card.collect_params().items():
            if p.grad_req != "null":
                host_params[n].grad()[:] = p.grad().asnumpy()
        src, dst = (t._updaters[0] for t in trainers)
        dst.states = {i: tuple(mx.nd.array(v.asnumpy(), ctx=mx.cpu())
                               for v in st) for i, st in src.states.items()}
        dst.states_synced = dict.fromkeys(dst.states, True)

    steps, fails = [], []
    for step, (x, y) in enumerate(data[:2]):
        sync_host()
        before = gluon_values(host)
        (out, loss), (out_ref, loss_ref) = (
            gluon_record(mx, n, loss_fn, *arrays(ctx, x, y))
            for n, ctx in ((card, mx.gpu(0)), (host, mx.cpu())))
        got, want = (o.data.detach().softmax(-1).cpu().numpy()
                     for o in (out, out_ref))
        check(got.shape == (GLUON_CHECK_BATCH, CLASSES)
              and bool(np.isfinite(got).all()),
              "Gluon step %d output not finite" % step)
        stats, stats_ref = ({n: v for n, v in gluon_values(m).items()
                             if "running" in n} for m in (card, host))
        for what, a, b in (("outputs", got, want),
                           ("losses", loss.asnumpy(), loss_ref.asnumpy())):
            if not np.allclose(a, b, rtol=RESNET_RTOL, atol=RESNET_ATOL):
                fails.append("step %d %s" % (step, what))
        fails += ["step %d moving statistic %s" % (step, n)
                  for n, v in stats_ref.items()
                  if not np.allclose(stats[n], v, rtol=RESNET_RTOL,
                                     atol=RESNET_ATOL)]
        grads, grads_ref = gluon_grads(card), gluon_grads(host)
        noise = {n: max(a, bias_noise(grads_ref)[n])
                 for n, a in bias_noise(grads).items()}
        for g in (grads, grads_ref):
            for n in noise:
                del g[n]
        if opt_name == "adam":
            feed_host()
        for t in trainers:
            t.step(GLUON_CHECK_BATCH)
        moved, moved_ref = ({n: v - before[n] for n, v in
                             gluon_values(m).items() if n in grads}
                            for m in (card, host))
        worst = max(noise, key=noise.get)
        row = {"output_max_abs_err": float(np.abs(got - want).max()),
               "loss": [float(v) for v in loss.asnumpy()],
               "moving_stat_max_abs_err": max_abs(stats, stats_ref),
               "grad_rel": leaf_errs(grads, grads_ref),
               "update_rel": leaf_errs(moved, moved_ref),
               "conv_bias_grad_over_weight_grad": {
                   "max": noise[worst], "worst": worst,
                   "median": float(np.median(list(noise.values())))}}
        if noise[worst] > BIAS_NOISE:
            fails.append("step %d conv bias gradient %s: %.3g of its "
                         "weight's" % (step, worst, noise[worst]))
        if step == 1 and opt_name == "sgd":
            # control: the update without the momentum term
            lr, wd = opt["learning_rate"], opt["wd"]
            plain = {n: -lr * (g / GLUON_CHECK_BATCH + wd * before[n])
                     for n, g in grads.items()}
            row["control_update_without_momentum_rel"] = leaf_errs(
                plain, moved_ref)
        steps.append(row)
    # control: the gradients with every K5 dx zeroed on the card
    sync_host()
    k5 = nn_ops.conv1x1_s2_dgrad
    nn_ops.conv1x1_s2_dgrad = lambda dy, w2, h, w: dy.new_zeros(
        (dy.shape[0], h, w, w2.shape[1]))
    try:
        gluon_record(mx, card, loss_fn, *arrays(mx.gpu(0), *data[2]))
    finally:
        nn_ops.conv1x1_s2_dgrad = k5
    gluon_record(mx, host, loss_fn, *arrays(mx.cpu(), *data[2]))
    control_k5 = leaf_errs(*({n: v for n, v in gluon_grads(m).items()
                              if n in grads} for m in (card, host)))
    controls = {"K5 dx zeroed": control_k5["max"]}
    if opt_name == "sgd":
        controls["update without momentum"] = \
            steps[1]["control_update_without_momentum_rel"]["max"]
    else:   # control: Adam's third update on the card without correction
        sync_host()
        before = gluon_values(host)
        for n, ctx in ((card, mx.gpu(0)), (host, mx.cpu())):
            gluon_record(mx, n, loss_fn, *arrays(ctx, *data[2]))
        feed_host()
        adam = trainers[0]._optimizer
        adam._corrected_lr = lambda index, lr: lr
        try:
            trainers[0].step(GLUON_CHECK_BATCH)
        finally:
            del adam._corrected_lr
        trainers[1].step(GLUON_CHECK_BATCH)
        controls["Adam without bias correction"] = leaf_errs(*(
            {n: v - before[n] for n, v in gluon_values(m).items()
             if n in grads} for m in (card, host)))["max"]
    summary = {"batch": GLUON_CHECK_BATCH, "layout": "NHWC",
               "optimizer": opt_name, "opt": opt,
               "grad_rel_limit": GRAD_REL, "steps": steps,
               "control_k5_dx_zeroed_grad_rel": control_k5,
               "controls_max_rel": controls}
    log("%s f32 vs cpu %s" % (tag, json.dumps(summary)))
    for step, row in enumerate(steps):
        fails += ["step %d %s of %s: %.3g" % (step, kind, row[kind]["worst"],
                                              row[kind]["max"])
                  for kind in ("grad_rel", "update_rel")
                  if not row[kind]["max"] <= GRAD_REL]
    for what, reading in controls.items():
        if reading <= GRAD_REL:
            fails.append("control %s passes the limit: %.3g" % (what,
                                                                reading))
    check(not fails, "Gluon f32 card vs cpu (%s): %s" % (opt_name,
                                                       "; ".join(fails)))
    return summary


def phase_second_order(mx, rng):
    """Part 2: ``autograd.grad(create_graph=True)`` on the card against
    the CPU: d/dx of sum((dy/dx)^2) for y = sum(x^3 w), 36 x^3 w^2."""
    values = [rng.randn(4096).astype(np.float32) for _ in range(2)]
    got = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        x, w = (mx.nd.array(v, ctx=ctx) for v in values)
        x.attach_grad()
        with mx.autograd.record():
            y = (x * x * x * w).sum()
            g = mx.autograd.grad(y, x, create_graph=True)
            z = (g * g).sum()
        z.backward()
        got[str(ctx)] = x.grad.asnumpy()
    card, host = got[str(mx.gpu(0))], got[str(mx.cpu())]
    exact = 36.0 * values[0] ** 3 * values[1] ** 2
    row = {"card_vs_cpu_max_abs_err": float(np.abs(card - host).max()),
           "card_vs_exact_rel": rel_err(card, exact)}
    check(np.allclose(card, host, rtol=1e-5, atol=1e-5)
          and row["card_vs_exact_rel"] <= 1e-5,
          "second-order gradient on the card: %s" % row)
    return row


def gluon_loop(mx, layout, dtype, batch, rng, first_step_only=False,
               opt_name="sgd", opt=GLUON_OPT):
    """The example's loop: net, ``cast``, ``hybridize()``, Trainer, loss;
    GLUON_WARMUP warm-up steps, then GLUON_STEPS timed ones on one fixed
    batch, whose loss must fall: by the last step, or with
    ``first_step_only`` at the first update (at the example's lr 0.1 and
    batch 32 the loss then climbs, in the JAX package too:
    `tests/gluon_example_divergence.py`). Returns the net, its step
    function and the readings."""
    ctx = mx.gpu(0)
    net = gluon_net(mx, ctx, layout)
    if dtype != "float32":
        net.cast(dtype)
    net.hybridize()
    trainer = gluon_trainer(mx, net, opt, opt_name)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x = mx.nd.array(rng.rand(*gluon_shape(layout, batch)).astype(np.float32),
                    ctx=ctx, dtype=dtype)
    y = mx.nd.array(rng.randint(0, CLASSES, batch).astype(np.float32),
                    ctx=ctx)

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(batch)
        return loss

    from mxnet_tpu_torch import compiled
    before = compiled.compile_counts()
    warm = [step() for _ in range(GLUON_WARMUP)]
    row = timed_gluon_steps(step, batch)
    after = compiled.compile_counts()
    means = [float(v.data.detach().float().mean()) for v in warm] \
        + row["losses"]
    counts = {k: after[k] - before[k] for k in after}
    check(means[1 if first_step_only else -1] < means[0],
          "%s %s Gluon loop: the loss did not fall: %s" % (layout, dtype,
                                                          means))
    check(counts == {"compiles": 1, "cache_hits": GLUON_WARMUP
                     + GLUON_STEPS - 1, "retraces": 0, "uncaptured": 0},
          "%s %s Gluon loop compile counts %s: want the recorded signature "
          "compiled once, then hits" % (layout, dtype, counts))
    row.update(layout=layout, dtype=dtype, batch=batch, losses=means,
               optimizer=opt_name, compile_counts=counts,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    step.trainer = trainer
    return net, step, row


def timed_gluon_steps(step, batch):
    """GLUON_STEPS calls of ``step``: the wall time bracketed by
    ``synchronize``, the host's time to issue them, and the losses."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step() for _ in range(GLUON_STEPS)]
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    means = [float(v.data.detach().float().mean()) for v in losses]
    check(all(np.isfinite(means)), "Gluon losses not finite: %s" % means)
    return {"step_s": wall / GLUON_STEPS,
            "imgs_per_s": GLUON_STEPS * batch / wall,
            "host_s_per_step": host / GLUON_STEPS, "losses": means}


def phase_gluon(mx, rng, module_step):
    """Phase 19: Gluon training. Part 1 holds 2 f32 steps on the card
    against the CPU; part 2 a second-order gradient; part 3 runs the
    example's loop at its defaults (K5 never launches: NCHW); part 4 the
    bench's configuration with the gate on (K5 exactly 6 launches a step,
    every one on the wgmma route), then 10 steps with it off (none).
    Every kernel count is set to 0 before part 1 and read after part 4.
    Returns the K5 launches of that path, the bf16 loop's step function
    and the summary."""
    from mxnet_tpu_torch import ops
    k5 = ops.conv1x1_s2_dgrad
    others = {"fused_lstm": ops.fused_lstm,
              "fused_lstm_train": ops.fused_lstm_train,
              "lstm_bwd_recurrence": ops.lstm_bwd_recurrence,
              "flash_attention": ops.flash_attention, "rtc": mx.rtc.Kernel}
    os.environ["MXNET_CONV1X1_PALLAS"] = "1"
    for c in [k5] + list(others.values()):       # the Gluon path starts
        c.launches = 0
    k5.launches_by_route.update(wgmma=0, wmma=0, f32=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    check_summary = phase_gluon_check(mx, rng)
    k5_check = k5.launches
    second = phase_second_order(mx, rng)
    net, _, example = gluon_loop(mx, "NCHW", "float32", GLUON_BATCH, rng,
                                 first_step_only=True)
    k5_nchw = k5.launches - k5_check
    del net
    torch.cuda.empty_cache()
    routes = dict(k5.launches_by_route)
    net, step, bf16 = gluon_loop(mx, "NHWC", "bfloat16", GLUON_BF16_BATCH,
                                 rng)
    k5_launches = k5.launches                 # ... and ends here
    routes = {r: n - routes[r] for r, n in k5.launches_by_route.items()}
    other_launches = {k: c.launches for k, c in others.items()}
    bf16_steps = GLUON_WARMUP + GLUON_STEPS
    log("phase 19 K5 launches: %d in the f32 check, %d in the NCHW loop, "
        "%d in the bf16 loop by route %s; other kernels %s"
        % (k5_check, k5_nchw, k5_launches - k5_check - k5_nchw, routes,
           other_launches))
    check(k5_check == K5_PER_STEP * 2 and k5_nchw == 0
          and k5_launches == K5_PER_STEP * (2 + bf16_steps),
          "the Gluon path launched conv1x1_s2_dgrad %d times (%d in the 2 "
          "f32 steps, %d in the NCHW loop), want %d a gate-on step and "
          "none on NCHW" % (k5_launches, k5_check, k5_nchw, K5_PER_STEP))
    check(routes == {"wgmma": K5_PER_STEP * bf16_steps, "wmma": 0, "f32": 0},
          "the bf16 Gluon loop's K5 calls by route %s, want all wgmma"
          % routes)
    check(not any(other_launches.values()),
          "the Gluon path launched %s" % other_launches)
    k5.launches = 0
    os.environ["MXNET_CONV1X1_PALLAS"] = "0"
    try:
        gate_off = timed_gluon_steps(step, GLUON_BF16_BATCH)
    finally:
        os.environ["MXNET_CONV1X1_PALLAS"] = "1"
    gate_off["k5_launches"] = k5.launches
    check(k5.launches == 0, "with the gate off the Gluon loop launched "
          "conv1x1_s2_dgrad %d times" % k5.launches)
    summary = {"f32_vs_cpu": check_summary, "second_order": second,
               "example_defaults": example, "bf16_gate_on": bf16,
               "bf16_gate_off": gate_off,
               "module_step_imgs_per_s_same_config": module_step,
               "k5_launches": k5_launches, "k5_routes_bf16": routes,
               "seconds": time.perf_counter() - t0}
    return k5_launches, net, step, summary


def phase_gluon_profile(mx, net, step):
    """One gate-on bf16 batch-128 Gluon step under torch.profiler, each
    op and the Trainer's update in a named range: device time by kernel
    class, the idle share and K5's launches and ms."""
    trainer_cls = mx.gluon.Trainer
    with ranged_ops([(trainer_cls, "_update")]):
        row = profiled_step(step)
    k5 = row["classes"].get("K5 conv1x1_s2_dgrad", {"launches": 0, "ms": 0.0})
    row["k5"] = {"launches": k5["launches"], "ms": k5["ms"]}
    check(k5["launches"] == K5_PER_STEP,
          "the profiled Gluon step shows %d K5 launches, want %d"
          % (k5["launches"], K5_PER_STEP))
    return row


@contextlib.contextmanager
def example_spy(mx):
    """Record the devices of every NDArray a Gluon block is called with
    and of every parameter a Trainer steps, while an example runs."""
    seen = {"data": set(), "params": set(), "steps": 0}
    block_call = mx.gluon.Block.__call__
    trainer_step = mx.gluon.Trainer.step

    def call(self, *args):
        seen["data"].update(str(a.data.device) for a in args
                            if isinstance(a, mx.nd.NDArray))
        return block_call(self, *args)

    def step(self, *args, **kwargs):
        seen["params"].update(str(p.data().data.device)
                              for p in self._params)
        seen["steps"] += 1
        return trainer_step(self, *args, **kwargs)

    mx.gluon.Block.__call__, mx.gluon.Trainer.step = call, step
    try:
        yield seen
    finally:
        mx.gluon.Block.__call__, mx.gluon.Trainer.step = \
            block_call, trainer_step


def run_example_captured(mx, rel, argv, device):
    """``tools/run_example`` on ``examples/rel``: its printed lines and
    the devices its blocks and Trainer saw."""
    from mxnet_tpu_torch.tools.run_example import run_example
    out = io.StringIO()
    t0 = time.perf_counter()
    with example_spy(mx) as seen, contextlib.redirect_stdout(out):
        run_example(os.path.join("examples", rel), argv, device)
    seen = {k: sorted(v) if isinstance(v, set) else v
            for k, v in seen.items()}
    return {"lines": out.getvalue().splitlines(), "seen": seen,
            "seconds": time.perf_counter() - t0}


def line_value(lines, prefix, what):
    """The first number after ``prefix`` in the first line holding it."""
    hit = [ln for ln in lines if prefix in ln]
    check(hit, "%s printed no %r line: %s" % (what, prefix, lines[-5:]))
    return float(re.search(r"[-+0-9.]+", hit[0].split(prefix, 1)[1]).group())


def phase_nd_ops(mx):
    """Phase 20a: every op of the nd core on gpu(0) against cpu() (f32 and
    bf16; ``tools/op_sweep.py``), each f32 family's control, and
    ``Dropout`` at p = 0.5 over DROPOUT_N elements on the card."""
    from mxnet_tpu_torch.tools import op_sweep
    t0 = time.perf_counter()
    ctx = mx.gpu(0)
    families, fails = op_sweep.sweep(ctx)
    controls = {f: op_sweep.control(ctx, f) for f in op_sweep.LIMITS
                if f != "exact"}
    sort = next(c for c in op_sweep.CASES if c.name == "sort")
    moved = op_sweep.run_case(sort, ctx)
    moved[0][0, 0] = torch.nextafter(moved[0][0, 0], torch.tensor(1e9))
    controls["exact"] = op_sweep.reading(moved, op_sweep.run_case(
        sort, mx.cpu()), "exact")
    rows = {"%s %s" % k: {"cases": n, "worst": worst,
                          "limit": op_sweep.LIMITS[k[0]]
                          if k[1] == "float32" or k[0] == "exact"
                          else op_sweep.BF16_LIMIT}
            for k, (n, worst) in sorted(families.items())}
    log("phase 20 op sweep %s" % json.dumps({
        "families": rows, "controls": controls,
        "cases": len(op_sweep.CASES), "over_limit": [str(f) for f in fails],
        "seconds": time.perf_counter() - t0}))
    check(not fails, "ops over their family's limit on the card: %s"
          % fails)
    check(all(controls[f] > op_sweep.LIMITS[f] for f in controls),
          "a control passed its family's limit: %s" % controls)

    rng = np.random.RandomState(SEED + 80)
    x = mx.nd.array(rng.rand(DROPOUT_N).astype("f") + 0.5, ctx=ctx)

    def draw():
        return mx.nd.Dropout(x, p=0.5, mode="always")[0].data

    mx.random.seed(SEED + 80)
    a = draw()
    mx.random.seed(SEED + 80)
    b, c = draw(), draw()
    zero_share = float((a == 0).float().mean())
    sigma = 0.5 / DROPOUT_N ** 0.5
    kept = a != 0
    dropout = {"zero_share": zero_share, "sigma": sigma,
               "device": str(a.device),
               "survivors_times_2": bool(torch.equal(a[kept],
                                                     x.data[kept] * 2)),
               "same_seed_same_bits": bool(torch.equal(a, b)),
               "next_draw_differs": not torch.equal(a, c)}
    log("phase 20 Dropout %s" % json.dumps(dropout))
    check(a.device.type == "cuda" and abs(zero_share - 0.5) <= 4 * sigma
          and dropout["survivors_times_2"]
          and dropout["same_seed_same_bits"]
          and dropout["next_draw_differs"],
          "Dropout on the card: %s" % dropout)
    return {"families": rows, "controls": controls, "dropout": dropout}


def phase_examples(mx, gluon_rate):
    """Phase 20b-c: ``examples/adversary/fgsm_mnist.py`` through
    ``tools/run_example`` under ``with mx.gpu(0):`` and under ``with
    mx.cpu():`` (its accuracy lines, the devices its net and data saw),
    and ``examples/gluon/train_resnet50.py`` at its defaults (``--ctx
    tpu``, now cuda:0) with RESNET_EXAMPLE_ARGS: the example's img/s
    beside phase 19's for the same loop; then with ``--dtype bfloat16``,
    which the example's own code cannot run in either package (it casts
    the net, not its f32 input: the JAX package raises at the first
    convolution, `lax.conv_general_dilated requires arguments to have the
    same dtypes`), so the port must raise there too, before any step."""
    fgsm = {}
    for device in ("gpu", "cpu"):
        run = run_example_captured(mx, "adversary/fgsm_mnist.py",
                                   FGSM_ARGS, device)
        want = "cuda:0" if device == "gpu" else "cpu"
        fgsm[device] = {
            "clean_accuracy": line_value(run["lines"], "clean accuracy",
                                         "fgsm"),
            "adversarial_accuracy": line_value(
                run["lines"], "adversarial accuracy", "fgsm"),
            "devices": run["seen"], "seconds": run["seconds"]}
        check(run["seen"]["data"] == [want] and run["seen"]["params"]
              == [want] and run["seen"]["steps"] > 0,
              "fgsm under %s(0): the net and its data lived on %s"
              % (device, run["seen"]))
    log("phase 20 fgsm_mnist %s" % json.dumps(fgsm))
    run = run_example_captured(mx, "gluon/train_resnet50.py",
                               RESNET_EXAMPLE_ARGS, "gpu")
    hit = [ln for ln in run["lines"] if "img/s" in ln]
    check(hit, "train_resnet50 printed no img/s line: %s" % run["lines"])
    rate = float(re.search(r"([0-9.]+) img/s", hit[0]).group(1))
    check(run["seen"]["data"] == ["cuda:0"]
          and run["seen"]["params"] == ["cuda:0"]
          and run["seen"]["steps"] == 11,
          "train_resnet50 at --ctx tpu: %s" % run["seen"])
    resnet = {"line": hit[0], "imgs_per_s": rate, "phase19_imgs_per_s_same_loop":
              gluon_rate, "devices": run["seen"],
              "seconds": run["seconds"]}
    try:
        run_example_captured(mx, "gluon/train_resnet50.py",
                             RESNET_EXAMPLE_ARGS + ["--dtype", "bfloat16"],
                             "gpu")
        bf16_error = None
    except RuntimeError as e:
        bf16_error = str(e).splitlines()[0]
    resnet["bfloat16"] = bf16_error
    log("phase 20 train_resnet50 %s" % json.dumps(resnet))
    check(bf16_error is not None and "should be the same" in bf16_error,
          "train_resnet50 --dtype bfloat16: want the dtype mismatch the "
          "JAX package raises, got %r" % bf16_error)
    return {"fgsm": fgsm, "train_resnet50": resnet}


# ---------------------------------------------------------------------------
# the optimizer slice: every optimizer through one multi-tensor update path,
# U1 (csrc/multi_tensor_update.cu), with Adam and multi-precision SGD
# ---------------------------------------------------------------------------
def resnet_param_shapes(mx):
    """The shapes of ResNet-50 v1's trainable parameters (NHWC)."""
    net = gluon_net(mx, mx.gpu(0), "NHWC")
    net(mx.nd.zeros(gluon_shape("NHWC", 1), ctx=mx.gpu(0)))
    shapes = [p.shape for p in net.collect_params().values()
              if p.grad_req != "null"]
    del net
    return shapes


def u1_lists(formula, dtype, shapes, seed, device="cuda"):
    """(weight, gradient, states) on the card for every shape, from a
    seed: states positive (Adam's variance), an mp formula's master copy
    the weight in f32."""
    from mxnet_tpu_torch.ops.multi_tensor import FORMULAS
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for shape in shapes:
        w = torch.randn(shape, generator=gen, device=device)
        g = torch.randn(shape, generator=gen, device=device) * 3
        states = [torch.rand(shape, generator=gen, device=device) + 0.1
                  for _ in range(FORMULAS[formula][2])]
        if formula.startswith("mp_"):
            states[-1] = w.to(dtype).float()
        out.append((w.to(dtype), g.to(dtype), tuple(states)))
    return out


def u1_args(lists):
    return [list(x) for x in zip(*lists)]


def u1_clone(lists):
    return [(w.clone(), g, tuple(s.clone() for s in st))
            for w, g, st in lists]


def u1_readings(got, want, dtype):
    """(largest |kernel - plain| over weights and states, fails): f32
    values to U1_RTOL/U1_ATOL, bf16 weights one bf16 step apart."""
    worst, fails = 0.0, 0
    for (w, _, st), (w_ref, _, st_ref) in zip(got, want):
        pairs = [(w.float(), w_ref.float(), dtype == torch.bfloat16)] + [
            (a, b, False) for a, b in zip(st, st_ref)]
        for a, b, bf16 in pairs:
            diff = (a - b).abs()
            worst = max(worst, float(diff.max()))
            rtol, atol = (2.0 ** -7, U1_ATOL) if bf16 else (U1_RTOL, U1_ATOL)
            fails += int((diff > atol + rtol * b.abs()).sum())
    return worst, fails


def u1_bound(formula, dtype, values):
    """(ms, "bytes" | "operations") of one U1 call over ``values``."""
    item = 2 if dtype == torch.bfloat16 else 4
    return bound_of(values * U1_BYTES[formula](item) / PEAK_BYTES_PER_S * 1e3,
                    values * U1_OPS[formula] / PEAK_F32_FLOPS * 1e3)


def library_optimizer(formula, lists):
    """One PyTorch call computing the update over the same tensors (fused
    ``torch.optim.SGD`` or ``Adam``; never on the port's path), or None."""
    params = []
    for w, g, _ in lists:
        p = w.clone().requires_grad_()
        p.grad = g.clone()
        params.append(p)
    if formula == "adam":
        return torch.optim.Adam(params, lr=1e-3, weight_decay=1e-4,
                                fused=True)
    return torch.optim.SGD(params, lr=0.1, momentum=0.9, weight_decay=1e-4,
                           fused=True)


def phase_u1(shapes):
    """Phase 21a: U1 against its plain version on the card at ResNet-50's
    parameter shapes, for every formula and weight dtype, clipping off and
    on, rescale_grad 0.25, per-tensor lrs and wds, 3 updates each; U1_CALLS
    calls from the same inputs bit-identical for (a)'s and (b)'s formulas;
    their kernel, plain and fused-torch.optim times and the bound."""
    from mxnet_tpu_torch.ops.multi_tensor import (
        FORMULAS, UpdateBuffers, multi_tensor_update,
        multi_tensor_update_plain)
    n = len(shapes)
    values = sum(int(np.prod(s)) for s in shapes)
    lrs = [0.01 * (1 + k % 7) for k in range(n)]
    wds = [1e-4 * (k % 3) for k in range(n)]
    kw = dict(rescale_grad=0.25, momentum=0.9, beta1=0.9, beta2=0.999,
              epsilon=1e-8)
    rows, fails, worst = [], [], 0.0
    for formula in FORMULAS:
        for dtype in (torch.float32, torch.bfloat16):
            for clip in (-1.0, 1.0):
                got = u1_lists(formula, dtype, shapes, SEED + 210)
                want = u1_clone(got)
                buffers = UpdateBuffers()
                for _ in range(3):
                    multi_tensor_update(formula, *u1_args(got), lrs, wds,
                                        clip_gradient=clip, buffers=buffers,
                                        **kw)
                    multi_tensor_update_plain(formula, *u1_args(want), lrs,
                                              wds, clip_gradient=clip, **kw)
                torch.cuda.synchronize()
                err, bad = u1_readings(got, want, dtype)
                worst = max(worst, err)
                rows.append({"formula": formula, "dtype": str(dtype)[6:],
                             "clip": clip, "max_abs_err": err,
                             "over_tolerance": bad})
                if bad:
                    fails.append("%s %s clip %s: %d values" % (
                        formula, dtype, clip, bad))
                del got, want
    timed = {}
    for key, formula, dtype in (("a", "mp_sgd_mom", torch.bfloat16),
                                ("b", "adam", torch.float32)):
        start = u1_lists(formula, dtype, shapes, SEED + 211)
        lists = u1_clone(start)
        buffers = UpdateBuffers()
        outs = []
        for _ in range(U1_CALLS):
            for (w, _, st), (w0, _, st0) in zip(lists, start):
                w.copy_(w0)
                for a, b in zip(st, st0):
                    a.copy_(b)
            multi_tensor_update(formula, *u1_args(lists), lrs, wds,
                                clip_gradient=1.0, buffers=buffers, **kw)
            outs.append(torch.cat([w.float().flatten() for w, _, _ in
                                   lists]))
        same = all(torch.equal(o, outs[0]) for o in outs)
        del outs

        def kernel():
            multi_tensor_update(formula, *u1_args(lists), lrs, wds,
                                clip_gradient=1.0, buffers=buffers, **kw)

        def plain():
            multi_tensor_update_plain(formula, *u1_args(lists), lrs, wds,
                                      clip_gradient=1.0, **kw)

        library = library_optimizer(formula, lists)
        bound, by = u1_bound(formula, dtype, values)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(U1_CALLS):
            kernel()
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3 / U1_CALLS
        # the card's time of the kernel alone: the wrapper's host work (the
        # table's key, the lr/wd copy) takes longer than the kernel, and
        # its pinned ring waits for the card, so events over queued calls
        # would time the host
        _, kern = device_profile(
            lambda: [kernel() for _ in range(5)],
            complete=lambda k: any("multi_tensor_kernel" in n for n in k))
        seen = [v for n, v in kern.items() if "multi_tensor_kernel" in n]
        check(seen, "the profiler saw no U1 kernel: %s" % sorted(kern))
        count, dev_ms = seen[0]
        timed[key] = {"formula": formula, "dtype": str(dtype)[6:],
                      "tensors": n, "values": values,
                      "bit_identical_calls": same,
                      "ms": dev_ms / count, "profiled_launches": count,
                      "call_wall_ms": call_ms,
                      "plain_ms": time_ms(plain, 3),
                      "library_ms": time_ms(library.step, 20),
                      "bound_ms": bound, "bound_by": by}
        if not same:
            fails.append("%s: %d calls from the same inputs differ"
                         % (formula, U1_CALLS))
        del start, lists, library
    summary = {"shapes": n, "values": values, "checks": rows,
               "max_abs_err": worst, "timed": timed,
               "rtol": U1_RTOL, "atol": U1_ATOL}
    log("phase 21 U1 vs plain %s" % json.dumps(summary))
    check(not fails, "U1 against its plain version: " + "; ".join(fails))
    torch.cuda.empty_cache()
    return summary


def phase_state_files(mx, tmp):
    """Phase 21e: ``save_states`` / ``load_states`` on the card. An MLP
    (784-1024-1024-10, the second layer bf16) trained 3 steps without a
    break, and the same from the same weights for 2 steps, saved, loaded
    into a fresh Trainer and stepped once: every parameter bit-identical,
    for (a)'s and (b)'s optimizers."""
    ctx = mx.gpu(0)
    rng = np.random.RandomState(SEED + 212)
    x = mx.nd.array(rng.randn(64, 784).astype(np.float32), ctx=ctx)
    y = mx.nd.array(rng.randint(0, 10, 64).astype(np.float32), ctx=ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    rows = {}
    for name, opt in (("sgd", OPT_A), ("adam", OPT_B)):
        nets = []
        for _ in range(2):
            mx.random.seed(SEED + 212)
            net = mx.gluon.nn.HybridSequential(prefix="mlp_")
            with net.name_scope():
                net.add(mx.gluon.nn.Dense(1024, activation="relu",
                                          in_units=784),
                        mx.gluon.nn.Dense(1024, activation="relu",
                                          in_units=1024),
                        mx.gluon.nn.Dense(10, in_units=1024))
            net.initialize(mx.init.Xavier(), ctx=ctx)
            net[1].cast("bfloat16")
            nets.append(net)

        def step(net, trainer):
            with mx.autograd.record():
                h = net[1](net[0](x).astype("bfloat16")).astype("float32")
                loss = loss_fn(net[2](h), y)
            loss.backward()
            trainer.step(64)

        whole = gluon_trainer(mx, nets[0], opt, name)
        for _ in range(3):
            step(nets[0], whole)
        first = gluon_trainer(mx, nets[1], opt, name)
        for _ in range(2):
            step(nets[1], first)
        fname = os.path.join(tmp, "%s.states" % name)
        first.save_states(fname)
        fresh = gluon_trainer(mx, nets[1], opt, name)
        fresh.load_states(fname)
        step(nets[1], fresh)
        diff = {n: float((a.data().data.detach().float()
                          - b.data().data.detach().float()).abs().max())
                for (n, a), (_, b) in zip(
                    sorted(nets[0].collect_params().items()),
                    sorted(nets[1].collect_params().items()))}
        rows[name] = {"max_abs_diff": max(diff.values()),
                      "bytes": os.path.getsize(fname)}
        check(not any(diff.values()), "%s: the step after load_states "
              "differs from the uninterrupted one: %s" % (name, diff))
    return rows


def phase_adam_examples(mx):
    """Phase 21f: the five Adam examples through ``tools/run_example`` on
    gpu(0) at their tests' arguments: each prints its asserted line, its
    net and data on cuda:0, one U1 launch a Trainer step (one f32 group)."""
    from mxnet_tpu_torch.ops.multi_tensor import multi_tensor_update
    rows = {}
    for rel, argv, line in ADAM_EXAMPLES:
        before = multi_tensor_update.launches
        run = run_example_captured(mx, rel, argv, "gpu")
        hit = [ln for ln in run["lines"] if line in ln]
        rows[rel] = {"line": hit[0] if hit else None,
                     "devices": run["seen"], "seconds": run["seconds"],
                     "u1_launches": multi_tensor_update.launches - before}
        check(hit, "%s printed no %r line: %s" % (rel, line,
                                                  run["lines"][-5:]))
        check(run["seen"]["data"] == ["cuda:0"]
              and run["seen"]["params"] == ["cuda:0"]
              and rows[rel]["u1_launches"] == run["seen"]["steps"] > 0,
              "%s on gpu(0): %s" % (rel, rows[rel]))
    return rows


def u1_groups(net):
    """The (formula, dtype) groups of a net under (a)'s or (b)'s
    optimizer: one a weight dtype."""
    return len({p.data().data.dtype for p in net.collect_params().values()
                if p.grad_req != "null"})


def phase_optimizer(mx, rng, gluon, tmp):
    """Phase 21 after part a: the path of this slice. 2 f32 batch-4 steps
    on the card against the CPU with (a)'s and with (b)'s optimizer (phase
    19's check and controls, Adam's own control); the example's loop at
    full width for (a) (NHWC bf16 batch 128, the gate on: K5 exactly 6
    launches a step, U1 one a group a step) and (b) (NCHW f32 batch 32,
    Adam), img/s beside phase 19's SGD loops; one profiled step of each
    (the optimizer's kernels and share); the state files; the five Adam
    examples. Returns the summary and the U1 and K5 launches."""
    from mxnet_tpu_torch.ops.multi_tensor import multi_tensor_update
    k5 = mx.ops.conv1x1_s2_dgrad
    os.environ["MXNET_CONV1X1_PALLAS"] = "1"
    t0 = time.perf_counter()
    checks = {"a_sgd_multi_precision": phase_gluon_check(
        mx, rng, "sgd", OPT_A_CHECK, "phase 21 (a) optimizer"),
        "b_adam": phase_gluon_check(mx, rng, "adam", OPT_B_CHECK,
                                    "phase 21 (b) optimizer")}
    loops, profiles = {}, {}
    for key, layout, dtype, batch, name, opt in (
            ("a", "NHWC", "bfloat16", GLUON_BF16_BATCH, "sgd", OPT_A),
            ("b", "NCHW", "float32", GLUON_BATCH, "adam", OPT_B)):
        u1, k5_0 = multi_tensor_update.launches, k5.launches
        net, step, row = gluon_loop(mx, layout, dtype, batch, rng,
                                    first_step_only=key == "b",
                                    opt_name=name, opt=opt)
        steps = GLUON_WARMUP + GLUON_STEPS
        groups = u1_groups(net)
        row.update(u1_launches=multi_tensor_update.launches - u1,
                   u1_groups=groups, k5_launches=k5.launches - k5_0)
        loops[key] = row
        check(row["u1_launches"] == groups * steps,
              "(%s) launched U1 %d times in %d steps of %d groups"
              % (key, row["u1_launches"], steps, groups))
        want_k5 = K5_PER_STEP * steps if layout == "NHWC" else 0
        check(row["k5_launches"] == want_k5,
              "(%s) launched K5 %d times, want %d" % (key, row["k5_launches"],
                                                     want_k5))
        with ranged_ops([(step.trainer, "_update")]):
            prof = profiled_step(step)
        classes = prof["classes"]
        u1_cls = classes.get("U1 multi_tensor_update",
                             {"launches": 0, "ms": 0.0})
        other = classes.get("optimizer update", {"launches": 0, "ms": 0.0})
        profiles[key] = {
            "step_wall_ms": prof["step_wall_ms"],
            "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "kernels": prof["kernels"],
            "u1": u1_cls, "other_update_kernels": other,
            "optimizer_device_share": (u1_cls["ms"] + other["ms"])
            / prof["device_busy_ms"],
            "update_host_ms": prof["update_host_ms"],
            "update_host_share": prof["update_host_ms"]
            / prof["step_wall_ms"],
            "classes": {k: {"launches": v["launches"], "ms": v["ms"]}
                        for k, v in classes.items()}}
        check(u1_cls["launches"] == groups,
              "the profiled (%s) step shows %d U1 launches, want %d"
              % (key, u1_cls["launches"], groups))
        del net, step
        torch.cuda.empty_cache()
    states = phase_state_files(mx, tmp)
    examples = phase_adam_examples(mx)
    summary = {"card_vs_cpu": checks, "loops": loops,
               "phase19_sgd_imgs_per_s": {
                   "bf16_gate_on": gluon["bf16_gate_on"]["imgs_per_s"],
                   "example_defaults": gluon["example_defaults"][
                       "imgs_per_s"]},
               "profiles": profiles, "state_files": states,
               "adam_examples": examples,
               "seconds": time.perf_counter() - t0}
    return summary

# ---------------------------------------------------------------------------
# the detection slice: SSD and Faster-RCNN through Gluon, the box ops, and
# greedy NMS as N1 (csrc/greedy_nms.cu)
# ---------------------------------------------------------------------------
def n1_inputs(mx, op_fn):
    """Run ``op_fn`` once and return the (boxes, valid, class ids, thresh)
    it handed greedy NMS (`ops/contrib_ops.py`'s call of N1's wrapper)."""
    from mxnet_tpu_torch.ops import contrib_ops
    calls = []
    wrapper = contrib_ops.greedy_nms

    def spy(boxes, valid, cls, thresh):
        calls.append((boxes, valid, cls, thresh))
        return wrapper(boxes, valid, cls, thresh)

    contrib_ops.greedy_nms = spy
    try:
        op_fn()
    finally:
        contrib_ops.greedy_nms = wrapper
    check(len(calls) == 1, "the op called greedy NMS %d times" % len(calls))
    return calls[0]


def n1_bound(batch, n):
    """(ms, "bytes" | "operations") of N1 over ``batch`` images of ``n``
    sorted boxes: the IoU tests of the upper triangle at the f32 rate, or
    boxes, class ids and valid flags read and the keep mask written."""
    flops = batch * n * (n - 1) / 2 * N1_OPS_PER_PAIR
    nbytes = batch * n * (16 + 4 + 1 + 1)
    return bound_of(nbytes / PEAK_BYTES_PER_S * 1e3,
                    flops / PEAK_F32_FLOPS * 1e3)


def n1_row(mx, what, op_fn, reps=20):
    """N1 against its plain version on one op's input on the card: the
    mismatching keep flags (must be 0), N1_CALLS calls bit-identical, and
    CUDA-event times of N1, of the whole op and of the plain version; the
    device time of N1's two kernels (the mask pass and the sweep) from a
    profile; the bound."""
    from mxnet_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain
    boxes, valid, cls, thresh = n1_inputs(mx, op_fn)
    batch, n = boxes.shape[0], boxes.shape[1]
    got = greedy_nms(boxes, valid, cls, thresh)
    want = greedy_nms_plain(boxes, valid, cls, thresh)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    same = all(torch.equal(greedy_nms(boxes, valid, cls, thresh), got)
               for _ in range(N1_CALLS - 1))
    _, kern = device_profile(
        lambda: greedy_nms(boxes, valid, cls, thresh),
        complete=lambda k: any("nms_sweep" in name for name in k))
    parts = {part: sum(v[1] for name, v in kern.items() if part in name)
             for part in ("nms_mask", "nms_sweep")}
    bound, by = n1_bound(batch, n)
    row = {"input": what, "batch": batch, "boxes": n, "thresh": thresh,
           "classes": cls is not None, "kept": int(got.sum()),
           "mismatches": mismatches, "bit_identical_calls": same,
           "ms": time_ms(lambda: greedy_nms(boxes, valid, cls, thresh), reps),
           "mask_pass_ms": parts["nms_mask"], "sweep_ms": parts["nms_sweep"],
           "op_ms": time_ms(op_fn, reps),
           "plain_ms": time_ms(lambda: greedy_nms_plain(boxes, valid, cls,
                                                        thresh), 1),
           "bound_ms": bound, "bound_by": by, "library_ms": None,
           "mask_bytes": batch * n * ((n + 63) // 64) * 8}
    check(mismatches == 0 and same, "N1 on %s: %d keep flags differ from "
          "the plain version, bit-identical calls %s" % (what, mismatches,
                                                        same))
    return row


def proposal_defaults(mx, device):
    """``_contrib_Proposal`` at Faster-RCNN's defaults on ``device``."""
    from mxnet_tpu_torch.ops.registry import get_op
    rng = np.random.RandomState(SEED + 220)
    h, w = PROPOSAL_MAP
    a = len(PROPOSAL_PARAMS["scales"]) * len(PROPOSAL_PARAMS["ratios"])
    logits = rng.randn(1, 2, a, h, w)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    ins = [prob.reshape(1, 2 * a, h, w), rng.randn(1, 4 * a, h, w) * 0.2,
           np.array([[h * 16, w * 16 - 8, 1.0]])]
    ins = [torch.from_numpy(x.astype(np.float32)).to(device) for x in ins]
    params = dict(PROPOSAL_PARAMS, _ctx=mx.gpu(0))
    op = get_op("_contrib_Proposal")
    return lambda: op.fcompute(params, *ins)


def case_fn(mx, case, device):
    """One call of a detection_sweep case's op on ``device``."""
    from mxnet_tpu_torch.ops.registry import get_op
    ins = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
           for a in case.arrays]
    params = dict(case.params, _ctx=mx.gpu(0), _is_train=False)
    op = get_op(case.name)
    return lambda: op.fcompute(params, *ins)


def phase_n1(mx, device):
    """Phase 22a: N1 against its plain version on the card on the inputs
    of Proposal at Faster-RCNN's defaults and of MultiBoxDetection at
    SSD300's layout (batch 32 with nms_topk 400, batch 2 without), and at
    the examples' own shapes (the RCNN example's Proposal, TinySSD's
    MultiBoxDetection)."""
    from mxnet_tpu_torch.tools import detection_sweep
    ssd300 = [c for c in detection_sweep.SSD300_CASES
              if c.name == "_contrib_MultiBoxDetection"]
    topk = next(c for c in ssd300 if "nms_topk" in c.params)
    full = next(c for c in ssd300 if c.params == {"nms_threshold": 0.45})
    ex_prop = next(c for c in detection_sweep.CASES
                   if c.name == "_contrib_Proposal")
    ex_det = next(c for c in detection_sweep.CASES
                  if c.name == "_contrib_MultiBoxDetection"
                  and c.arrays[0].shape[2] == 256
                  and c.params == {"nms_threshold": 0.45})
    rows = [n1_row(mx, "Proposal, Faster-RCNN defaults",
                   proposal_defaults(mx, device)),
            n1_row(mx, "MultiBoxDetection, SSD300, nms_topk 400",
                   case_fn(mx, topk, device)),
            n1_row(mx, "MultiBoxDetection, SSD300, no nms_topk",
                   case_fn(mx, full, device), reps=5),
            n1_row(mx, "Proposal, the RCNN example",
                   case_fn(mx, ex_prop, device)),
            n1_row(mx, "MultiBoxDetection, the SSD example",
                   case_fn(mx, ex_det, device))]
    topk_probs = topk.arrays[0]
    rows[1]["probability_bytes"] = topk_probs.size * 4
    for row in rows:
        log("phase 22 N1 %s" % json.dumps(row))
    return rows


def phase_detection_ops(mx):
    """Phase 22b: every op of the slice (`tools/detection_sweep.py`: the
    examples' shapes, and the MultiBox ops at SSD300's layout) on gpu(0)
    against cpu(), forward and gradients, each under
    ``set_sync_debug_mode("error")`` on the card, within its family's
    limit; each family's control (the card's inputs rounded to bf16) above
    it."""
    from mxnet_tpu_torch.tools import detection_sweep as sweep
    families, fails = {}, []
    t0 = time.perf_counter()
    for case in sweep.CASES + sweep.SSD300_CASES:
        try:
            fwd, grad = sweep.compare(case, mx.gpu(0), no_sync=True)
        except RuntimeError as e:
            fails.append("%s %s: %s" % (case.name, case.params,
                                        str(e).splitlines()[0]))
            continue
        row = families.setdefault(case.family, {"cases": 0, "forward": 0.0,
                                                "gradient": 0.0})
        row["cases"] += 1
        row["forward"] = max(row["forward"], fwd)
        row["gradient"] = max(row["gradient"], grad)
        if max(fwd, grad) > sweep.LIMITS[case.family]:
            fails.append("%s %s: forward %.3g, gradient %.3g, limit %g"
                         % (case.name, case.params, fwd, grad,
                            sweep.LIMITS[case.family]))
    controls = {f: sweep.control(mx.gpu(0), f)
                for f in sweep.LIMITS if f != "exact"}
    summary = {"families": families, "limits": sweep.LIMITS,
               "controls": controls, "sync_debug_mode": "error",
               "seconds": time.perf_counter() - t0}
    log("phase 22 detection ops %s" % json.dumps(summary))
    check(not fails, "detection ops on the card: " + "; ".join(fails))
    check(all(v > sweep.LIMITS[f] for f, v in controls.items()),
          "a detection family's control passed its limit: %s" % controls)
    return summary


@contextlib.contextmanager
def step_spy(mx, profile_after=None):
    """Stamp every Trainer step of an example run; with ``profile_after``
    = k, profile the training iteration between the k-th and the
    (k+1)-th step (device busy time and idle share, launches, N1's and
    U1's device time and share)."""
    from torch.profiler import ProfilerActivity, profile
    rec = {"times": [], "profile": None}
    trainer_step = mx.gluon.Trainer.step
    state = {}

    def step(self, *args, **kwargs):
        out = trainer_step(self, *args, **kwargs)
        k = len(rec["times"])
        rec["times"].append(time.perf_counter())
        if profile_after is not None and k + 1 == profile_after:
            torch.cuda.synchronize()
            state["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
            state["prof"].start()
            state["t0"] = time.perf_counter()
        elif "prof" in state and k + 1 == profile_after + 1:
            torch.cuda.synchronize()
            wall = (time.perf_counter() - state["t0"]) * 1e3
            prof = state.pop("prof")
            prof.stop()
            rec["profile"] = iteration_profile(prof, wall)
        return out

    mx.gluon.Trainer.step = step
    try:
        yield rec
    finally:
        mx.gluon.Trainer.step = trainer_step


def iteration_profile(prof, wall):
    """Device busy ms, idle share and launches of one profiled iteration,
    with N1's (nms_mask, nms_sweep) and U1's kernels apart."""
    busy, launches, n1, u1, top = 0.0, 0, [0, 0.0], [0, 0.0], {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        ms = e.self_device_time_total / 1e3
        busy += ms
        launches += e.count
        top[e.key[:50]] = ms
        part = n1 if ("nms_mask" in e.key or "nms_sweep" in e.key) else \
            u1 if "multi_tensor_kernel" in e.key else None
        if part is not None:
            part[0] += e.count
            part[1] += ms
    check(launches > 0, "the profiler saw no device kernel in the iteration")
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall, "launches": launches,
            "n1": {"launches": n1[0], "ms": n1[1],
                   "share": n1[1] / busy if busy else None},
            "u1": {"launches": u1[0], "ms": u1[1],
                   "share": u1[1] / busy if busy else None},
            "top": sorted(top.items(), key=lambda kv: -kv[1])[:6]}


def phase_detection_examples(mx, counters):
    """Phase 22c: the SSD example (--ctx tpu) and the Faster-RCNN example
    in its four modes through ``tools/run_example`` on gpu(0) at their
    tests' arguments: each prints its asserted line, launches N1 and U1
    and none of K1-K6; the SSD loop's img/s (host clock between its first
    and last Trainer step); one profiled training iteration of SSD and of
    the plain Faster-RCNN run."""
    n1, u1 = counters["greedy_nms"], counters["multi_tensor_update"]
    others = {k: c for k, c in counters.items()
              if k not in ("greedy_nms", "multi_tensor_update")}
    runs = [("ssd", "ssd/train_ssd.py", SSD_EXAMPLE_ARGS,
             "detections kept after NMS", PROFILED_AFTER)]
    runs += [("faster_rcnn_" + mode, "rcnn/train_faster_rcnn.py", argv,
              "FASTER-RCNN FLOW OK", PROFILED_AFTER if mode == "plain"
              else None) for mode, argv in RCNN_MODES]
    rows = {}
    for key, rel, argv, line, prof_at in runs:
        before = {k: c.launches for k, c in counters.items()}
        with step_spy(mx, prof_at) as rec:
            run = run_example_captured(mx, rel, argv, "gpu")
        got = {k: c.launches - before[k] for k, c in counters.items()}
        hit = [ln for ln in run["lines"] if line in ln]
        t = rec["times"]
        row = {"line": hit[0] if hit else None, "devices": run["seen"],
               "seconds": run["seconds"], "steps": len(t),
               "launches": got, "profile": rec["profile"]}
        if key == "ssd":
            batch = int(argv[argv.index("--batch-size") + 1])
            row["imgs_per_s"] = batch * (len(t) - 1) / (t[-1] - t[0])
            row["kept_line"] = [ln for ln in run["lines"] if "agreement"
                                in ln]
        rows[key] = row
        log("phase 22 %s %s" % (key, json.dumps(row)))
        check(hit, "%s %s printed no %r line: %s" % (rel, argv, line,
                                                     run["lines"][-5:]))
        check(run["seen"]["data"] == ["cuda:0"]
              and run["seen"]["params"] == ["cuda:0"],
              "%s on gpu(0): its net and data lived on %s"
              % (key, run["seen"]))
        check(got["greedy_nms"] > 0 and got["multi_tensor_update"] > 0
              and not any(got[k] for k in others),
              "%s launched %s: want N1 and U1 only" % (key, got))
    return rows


def custom_block(mx, ctx):
    """A Gluon block calling ``F.Custom`` (a sigmoid on the host, in
    numpy) between two Dense layers, from seed SEED + 221."""
    gluon = mx.gluon

    class Net(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.a = gluon.nn.Dense(64, in_units=32)
                self.b = gluon.nn.Dense(8, in_units=64)

        def hybrid_forward(self, F, x):
            return self.b(F.Custom(self.a(x), op_type="smoke_sigmoid"))

    mx.random.seed(SEED + 221)
    net = Net(prefix="custom_")
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def register_smoke_sigmoid(mx):

    class Sigmoid(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], 1.0 / (1.0 + np.exp(-x)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy()
            self.assign(in_grad[0], req[0],
                        out_grad[0].asnumpy() * y * (1.0 - y))

    @mx.operator.register("smoke_sigmoid")
    class SigmoidProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()


def phase_custom(mx):
    """Phase 22d: ``Custom`` on the card. A block calling ``F.Custom`` on
    gpu(0) against the same block (same weights) on cpu(): a forward and
    the gradients of a recorded backward, eager and hybridized; the
    hybridized program's outputs on the card and counted as uncaptured
    (it runs eagerly on every call, outside any CUDA graph)."""
    from mxnet_tpu_torch import compiled
    register_smoke_sigmoid(mx)
    x_np = np.random.RandomState(SEED + 222).randn(16, 32).astype(np.float32)
    rows = {}
    for hybrid in (False, True):
        out, grads = {}, {}
        before = compiled.compile_counts()
        for key, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
            net = custom_block(mx, ctx)
            if hybrid:
                net.hybridize()
            x = mx.nd.array(x_np, ctx=ctx)
            with mx.autograd.record():
                y = net(x)
            y.backward()
            y2 = net(x)
            out[key] = (y.asnumpy(), y2.asnumpy(), str(y2.data.device))
            grads[key] = [p.grad().asnumpy() for _, p in sorted(
                net.collect_params().items())]
        after = compiled.compile_counts()
        err = max(float(np.abs(g - c).max()) for g, c in zip(
            out["card"][:2] + tuple(grads["card"]),
            out["cpu"][:2] + tuple(grads["cpu"])))
        rows["hybridized" if hybrid else "eager"] = {
            "max_abs_err": err, "device": out["card"][2],
            "uncaptured": after["uncaptured"] - before["uncaptured"]}
        check(err < 1e-5 and out["card"][2] == "cuda:0",
              "Custom block on gpu(0) vs cpu(): %s" % rows)
    log("phase 22 Custom %s" % json.dumps(rows))
    check(rows["hybridized"]["uncaptured"] == 2
          and rows["eager"]["uncaptured"] == 0,
          "the hybridized Custom block's programs (card and CPU) were not "
          "counted as uncaptured: %s" % rows)
    return rows



def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; it runs the port on the GPU",
              file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _build

    # full f32 everywhere, on the kernel's side and the references'
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = nvidia_smi()
    log("card: %s (torch %s, CUDA %s)" % (card, torch.__version__,
                                          torch.version.cuda))

    secs = _build.build_all()
    log("phase 1 build %s" % json.dumps({"sources": list(_build.SOURCES),
                                         "seconds": secs}))
    for name in _build.SOURCES:
        for line in (_build.build_log(name) or "").splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas %s: %s" % (name, line.strip()))

    rows, worst = phase_kernel(mx.ops, device)

    sym_json = lm_symbol(mx).tojson()
    host = lm_params(lm_symbol(mx), SEED)
    ref = Reference(mx, sym_json, mx.params_from_numpy(host, mx.cpu()))
    gpu_params = mx.params_from_numpy(host, mx.gpu(0))
    rng = np.random.RandomState(SEED + 1)

    k1_routes = mx.ops.fused_lstm.launches_by_route
    mx.ops.fused_lstm.launches = 0            # the main path starts here
    k1_routes.update(persistent=0, step=0)
    phase_predictor(mx, sym_json, gpu_params, ref, rng, mx.gpu(0))
    engine = phase_engine(mx, sym_json, gpu_params, ref, rng, mx.gpu(0))
    phase_http(mx, engine, ref, rng)
    launches = mx.ops.fused_lstm.launches     # ... and ends here
    serving_routes = dict(k1_routes)
    log("phase 5 fused_lstm launches by route %s" % json.dumps(
        serving_routes))
    check(launches > 0, "the main path never launched fused_lstm")
    check(serving_routes == {"persistent": launches, "step": 0},
          "the serving path's fused_lstm calls by route %s, want all %d "
          "persistent" % (serving_routes, launches))
    phase_profile(mx, sym_json, gpu_params, rng)

    train_rows, train_worst = phase_train_kernels(mx.ops, device)
    counters = (mx.ops.fused_lstm, mx.ops.fused_lstm_train,
                mx.ops.lstm_bwd_recurrence)
    u1 = mx.ops.multi_tensor_update
    u1.launches = 0
    for c in counters:                        # the training path starts
        c.launches = 0
        c.launches_by_route.update(persistent=0, step=0)
    mod, summary = phase_train(mx, mx.gpu(0), rng)
    k1, k2, k3 = (c.launches for c in counters)   # ... and ends here
    u1_lm = u1.launches
    routes = [dict(c.launches_by_route) for c in counters]
    steps = 4 + 2 * SCAN_STEPS + FIT_BATCHES
    summary.update(train_steps=steps, launches={
        "fused_lstm": k1, "fused_lstm_train": k2, "lstm_bwd_recurrence": k3,
        "multi_tensor_update": u1_lm},
        launches_by_route={"fused_lstm": routes[0],
                           "fused_lstm_train": routes[1],
                           "lstm_bwd_recurrence": routes[2]})
    check(routes == [{"persistent": k1, "step": 0},
                     {"persistent": k2, "step": 0},
                     {"persistent": k3, "step": 0}],
          "the training path's K1, K2 and K3 calls by route %s, want all "
          "persistent" % routes)
    log("phase 8 train %s" % json.dumps(summary))
    check(k2 == LAYERS * steps and k3 == LAYERS * steps,
          "training launched fused_lstm_train %d and lstm_bwd_recurrence %d "
          "times, want %d each (%d layers x %d steps)"
          % (k2, k3, LAYERS * steps, LAYERS, steps))
    check(u1_lm == steps, "the LM's SGD (momentum 0, clip 0.25) launched "
          "U1 %d times in %d steps, want one a step" % (u1_lm, steps))
    check(summary["k1_launches_by_score"] == LAYERS * EVAL_BATCHES,
          "score launched fused_lstm %d times, want %d"
          % (summary["k1_launches_by_score"], LAYERS * EVAL_BATCHES))
    phase_train_profile(mod, rng, mx)
    del mod

    t0 = time.perf_counter()
    log("phase 10 conv1x1_s2_dgrad ptxas %s" % json.dumps(k5_ptxas(mx.ops)))
    k5_rows = phase_k5(mx.ops, device)
    log("phase 10 seconds %.1f" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    os.environ["MXNET_CONV1X1_PALLAS"] = "1"
    k5 = mx.ops.conv1x1_s2_dgrad
    k5.launches = 0                           # the ResNet path starts here
    check_summary = phase_resnet_check(mx, rng)
    k5_check = k5.launches
    mod, batches, steps, mixed, train_summary = phase_resnet_train(mx, rng)
    k5_launches = k5.launches                 # ... and ends here
    check(k5_check == K5_PER_STEP * 2
          and k5_launches == K5_PER_STEP * (2 + steps),
          "the ResNet path launched conv1x1_s2_dgrad %d times (%d in the "
          "2 f32 steps), want %d per step over %d steps"
          % (k5_launches, k5_check, K5_PER_STEP, 2 + steps))
    k5.launches = 0
    off_summary = phase_resnet_gate_off(mod, batches)
    check(k5.launches == 0, "with the gate off conv1x1_s2_dgrad launched "
          "%d times" % k5.launches)
    off_summary["k5_launches"] = k5.launches
    log("phase 11 resnet50 %s" % json.dumps({
        "f32_vs_cpu": check_summary, "bf16_gate_on": train_summary,
        "bf16_gate_off": off_summary, "bf16_vs_f32_forward": mixed,
        "k5_launches": k5_launches, "k5_launches_f32_check": k5_check,
        "gate_on_steps_on_card": 2 + steps,
        "seconds": time.perf_counter() - t0}))
    log("phase 12 resnet50 profile %s" % json.dumps(
        phase_resnet_profile(mx, mod, batches[0])))
    del mod, batches
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    log("phase 13 flash_attention ptxas %s" % json.dumps(k4_ptxas(mx.ops)))
    k4_rows = phase_k4(mx.ops, device)
    log("phase 13 seconds %.1f" % (time.perf_counter() - t0))
    log("phase 14 attention op %s" % json.dumps(
        phase_attention_op(mx, mx.ops)))
    t0 = time.perf_counter()
    k4 = mx.ops.flash_attention
    k4.launches = 0                           # the attention path starts
    att_check = phase_attention_check(mx, mx.ops, rng)
    k4_check = k4.launches
    mod, batches, att_train = phase_attention_train(mx, rng)
    k4_launches = k4.launches                 # ... and ends here
    att_steps = 2 + ATT_WARMUP + ATT_STEPS
    check(k4_check == ATT_LAYERS * 2
          and k4_launches == ATT_LAYERS * att_steps,
          "the attention LM launched flash_attention %d times (%d in the 2 "
          "f32 steps), want %d per step over %d steps"
          % (k4_launches, k4_check, ATT_LAYERS, att_steps))
    log("phase 15 attention LM %s" % json.dumps({
        "f32_vs_cpu": att_check, "bf16_train": att_train,
        "k4_launches": k4_launches, "k4_launches_f32_check": k4_check,
        "steps_on_card": att_steps, "seconds": time.perf_counter() - t0}))
    log("phase 15 attention LM profile %s" % json.dumps(
        phase_attention_profile(mod, batches[0])))
    del mod, batches
    rtc_launches, rtc_row = phase_rtc(mx)
    log("phase 16 rtc %s" % json.dumps(rtc_row))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    log("phase 17 nd.random %s" % json.dumps(phase_random(mx)))
    counters = {"fused_lstm": mx.ops.fused_lstm,
                "fused_lstm_train": mx.ops.fused_lstm_train,
                "lstm_bwd_recurrence": mx.ops.lstm_bwd_recurrence,
                "conv1x1_s2_dgrad": k5, "flash_attention": k4,
                "rtc": mx.rtc.Kernel}
    for c in counters.values():               # the inference path starts
        c.launches = 0
    infer = [phase_infer(mx, layout) for layout in ("NCHW", "NHWC")]
    infer_launches = {k: c.launches for k, c in counters.items()}
    check(not any(infer_launches.values()),
          "ResNet-50 inference launched %s: no TPU kernel of the repo is on "
          "this path" % infer_launches)
    for row in infer:
        flops = 2.0 * row["macs_per_image"] * INFER_BATCH
        row.update(flops_per_batch=flops,
                   bound_ms_tf32=flops / PEAK_TF32_FLOPS * 1e3,
                   bound_ms_f32=flops / PEAK_F32_FLOPS * 1e3)
        log("phase 18 resnet50 inference %s" % json.dumps(row))
    rates = {}
    for layout in ("NCHW", "NHWC"):
        for tf32 in (True, False):
            rates["%s cudnn_tf32=%s" % (layout, tf32)] = phase_infer_rate(
                mx, layout, tf32)
    infer_launches = {k: c.launches for k, c in counters.items()}
    log("phase 18 img/s %s" % json.dumps({
        "rates": rates, "kernel_launches": infer_launches,
        "card": card, "seconds": time.perf_counter() - t0}))
    check(not any(infer_launches.values()),
          "ResNet-50 inference launched %s" % infer_launches)
    torch.cuda.empty_cache()

    gluon_k5, net, step, gluon = phase_gluon(
        mx, rng, train_summary["step_imgs_per_s"])
    log("phase 19 gluon training %s" % json.dumps(gluon))
    log("phase 19 gluon profile %s" % json.dumps(
        phase_gluon_profile(mx, net, step)))
    del net, step
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    nd_ops = phase_nd_ops(mx)
    for c in counters.values():               # the nd-core path starts
        c.launches = 0
    examples = phase_examples(mx, gluon["example_defaults"]["imgs_per_s"])
    nd_launches = {k: c.launches for k, c in counters.items()}
    log("phase 20 nd core %s" % json.dumps({
        "kernel_launches": nd_launches, "card": card,
        "seconds": time.perf_counter() - t0}))   # ... and ends here
    check(not any(nd_launches.values()),
          "the examples launched %s: no TPU kernel of the repo is on this "
          "path" % nd_launches)
    del nd_ops, examples
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    u1_summary = phase_u1(resnet_param_shapes(mx))
    log("phase 21a seconds %.1f" % (time.perf_counter() - t0))
    path = dict(counters, multi_tensor_update=u1)
    for c in path.values():                   # the optimizer path starts
        c.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        opt_summary = phase_optimizer(mx, rng, gluon, tmp)
    opt_launches = {k: c.launches for k, c in path.items()}   # ... ends here
    opt_summary.update(kernel_launches=opt_launches, card=card)
    log("phase 21 optimizer %s" % json.dumps(opt_summary))
    check(opt_launches["multi_tensor_update"] > 0
          and opt_launches["conv1x1_s2_dgrad"] > 0
          and not any(n for k, n in opt_launches.items()
                      if k not in ("multi_tensor_update",
                                   "conv1x1_s2_dgrad")),
          "the optimizer path launched %s: want U1 and K5 only"
          % opt_launches)

    t0 = time.perf_counter()
    n1_rows = phase_n1(mx, device)
    ops_summary = phase_detection_ops(mx)
    n1 = mx.ops.greedy_nms
    path = dict(counters, multi_tensor_update=u1, greedy_nms=n1)
    for c in path.values():                   # the detection path starts
        c.launches = 0
    det_examples = phase_detection_examples(mx, path)
    det_launches = {k: c.launches for k, c in path.items()}  # ... ends here
    custom = phase_custom(mx)
    log("phase 22 detection %s" % json.dumps({
        "kernel_launches": det_launches, "card": card,
        "ssd_imgs_per_s": det_examples["ssd"]["imgs_per_s"],
        "custom": custom, "seconds": time.perf_counter() - t0}))
    check(det_launches["greedy_nms"] > 0
          and det_launches["multi_tensor_update"] > 0
          and not any(n for k, n in det_launches.items()
                      if k not in ("greedy_nms", "multi_tensor_update")),
          "the detection path launched %s: want N1 and U1 only"
          % det_launches)
    del ops_summary

    top = next(r for r in rows if r["B"] == max(SERVED_BATCHES))
    train = next(r for r in train_rows if r["B"] == TRAIN_BATCH)
    pallas = "mxnet_tpu/ops/pallas_kernels.py"
    k3_src = "mxnet_tpu_torch/csrc/lstm_bwd_persistent.cuh"
    recurrence_src = "mxnet_tpu_torch/csrc/lstm_persistent.cuh"
    kernels = [{
        "name": "fused_lstm", "route": "cuda", "source": recurrence_src,
        "replaces": pallas + ":295",
        "launches": launches, "max_abs_err": worst,
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"]}, {
        "name": "fused_lstm_train", "route": "cuda",
        "source": recurrence_src,
        "replaces": pallas + ":348", "launches": k2,
        "max_abs_err": train_worst, "ms": train["k2_ms"],
        "plain_ms": train["k2_plain_ms"], "bound_ms": train["k2_bound_ms"],
        "bound_by": train["k2_bound_by"],
        "library_ms": train["cudnn_fwd_ms"]}, {
        "name": "lstm_bwd_recurrence", "route": "cuda", "source": k3_src,
        "replaces": pallas + ":382", "launches": k3,
        "max_abs_err": train_worst, "ms": train["k3_ms"],
        "plain_ms": train["k3_plain_ms"], "bound_ms": train["k3_bound_ms"],
        "bound_by": train["k3_bound_by"],
        "library_ms": train["cudnn_bwd_ms"]}]
    # K5: the six launches of one bf16 batch-128 train step, summed; the
    # step's bound is the larger of its summed byte and operation times
    step_rows = [r for r in k5_rows if r["dtype"] == "bfloat16" and "ms" in r]
    k5_bound, k5_by = bound_of(sum(r["bytes_ms"] for r in step_rows),
                               sum(r["operations_ms"] for r in step_rows))
    kernels.append({
        "name": "conv1x1_s2_dgrad", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/dgrad_wgmma.cuh",
        "replaces": "mxnet_tpu/ops/conv_kernels.py:66",
        "launches": k5_launches + gluon_k5,
        "max_abs_err": max(r["max_abs_err"] for r in k5_rows),
        **{key: sum(r[key] for r in step_rows)
           for key in ("ms", "plain_ms", "library_ms")},
        "bound_ms": k5_bound, "bound_by": k5_by})
    # K4: the LM's shape (B=1, T=4096, 8 heads of 128, bf16, causal)
    main4 = next(r for r in k4_rows if r["Tq"] == ATT_SEQ and r["causal"]
                 and r["dtype"] == "bfloat16")
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
        "replaces": pallas + ":220", "launches": k4_launches,
        "max_abs_err": max(r["max_abs_err"] for r in k4_rows),
        **{key: main4[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}})
    kernels.append({
        "name": "rtc", "route": "cuda", "source": "mxnet_tpu_torch/rtc.py",
        "replaces": "mxnet_tpu/rtc.py:78", "launches": rtc_launches,
        "max_abs_err": max(rtc_row["axpy_max_abs_err"],
                           rtc_row["row_sum_max_abs_err"]),
        **{key: rtc_row[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}})
    # U1: one (a) update of ResNet-50 (mp_sgd_mom over bf16 weights)
    u1_a = u1_summary["timed"]["a"]
    kernels.append({
        "name": "multi_tensor_update", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/multi_tensor_update.cu",
        "replaces": "mxnet_tpu/optimizer.py:666",
        "launches": opt_launches["multi_tensor_update"],
        "max_abs_err": u1_summary["max_abs_err"],
        **{key: u1_a[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}})
    # N1: Proposal at Faster-RCNN's defaults (one image, 6000 boxes)
    n1_main = n1_rows[0]
    kernels.append({
        "name": "greedy_nms", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/greedy_nms.cu",
        "replaces": "mxnet_tpu/ops/contrib_ops.py:73",
        "launches": det_launches["greedy_nms"],
        "max_abs_err": float(max(r["mismatches"] for r in n1_rows)),
        **{key: n1_main[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
