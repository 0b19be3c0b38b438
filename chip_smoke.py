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
   (T=35, B in {1, 8, 32}, I=H=650), at B = 3 and 64, at T = 1, at the
   speech model's (phase 25) T = 100, 200, 300 with B=32 and its decode's
   T = 300 with B=1, at a shape that takes the step route and at a ragged small
   shape, with
   kernel, plain and cuDNN (``torch.nn.LSTM``, timed as a yardstick only)
   times and the kernel's bound at the served shapes; each call's route
   against its plan (grid, units a block, rows, shared memory; every
   shape at H=650 persistent), the recurrence kernel's launches a call
   (1 on the persistent route) and device µs a step from a profile,
   ptxas's registers and spills, and 20 calls at B=32 bit-identical;
3. ``Predictor`` on ``gpu(0)`` vs the same ``Predictor`` on ``cpu()``:
   its first forward compiles (one captured CUDA graph; K1 counted at the
   capture's warm-up runs and its first replay), the second is one replay
   (a cache hit, K1 once a layer);
4. ``InferenceEngine`` on ``gpu(0)`` (buckets 1..32, each bucket's
   forward captured at warm-up) under 100 concurrent requests of 1-8 rows,
   sampled results held against the CPU reference, no capture under load;
5. the HTTP server in-process: two ``/predict`` requests, ``/healthz``,
   ``/shutdown``;
6. ``torch.profiler`` over one served forward (a replay) at the top
   bucket: device time by kernel, K1's share and launches (one persistent
   launch a layer) and the device's idle share; the host's runtime calls
   (one ``cudaGraphLaunch``, no kernel launch);

and then trains the same LM, the configuration of the training benchmark
(``examples/rnn/word_lm/benchmark.py``: batch 32, SGD with lr 1 and
``clip_gradient`` 0.25, Xavier init), in three more:

7. the training kernels ``fused_lstm_train`` (K2) and
   ``lstm_bwd_recurrence`` (K3) vs their plain versions, and a
   ``FusedLSTM`` layer's six gradients vs the plain backward, at T=35,
   B in {8, 32}, I=H=650, at the speech model's three buckets (B=32) and
   a ragged shape, with kernel, plain and cuDNN (forward, backward,
   both; timed as a yardstick only) times; K2 and K3
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
    the shapes of ResNet-50's trainable parameters for each of its six
    formulas (``sgd``, ``sgd_mom``, ``mp_sgd``, ``mp_sgd_mom``, ``adam``,
    ``mp_adam``) over f32
    and bf16 weights, clipping off and on, ``rescale_grad`` 0.25,
    per-tensor lrs and wds (0, 1 or 2 times 1e-4), 3 updates (f32 to rtol
    1e-6, atol 1e-7; bf16 weights one bf16 step; the master-copy formulas'
    weights and states bit for bit), 20 calls from the same inputs
    bit-identical in weights and states,
    with kernel, plain and fused ``torch.optim`` times (the yardstick
    only) and the bound, for (a)'s formula, (b)'s and ``mp_adam`` on bf16
    weights (its yardstick fused ``torch.optim.Adam`` on the f32 masters
    and a ``_foreach_copy_`` into the weights); then phase 19's
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

and then drives the sparse slice: ``nd.sparse`` arrays over their
compact payload, ``kv.create("local")`` with ``row_sparse_pull`` and the
optimizers' lazy row-sparse updates, one launch of S1 a push
(`mxnet_tpu_torch/csrc/sparse_row_update.cu`), in one more:

23. S1 against its plain version on the card at the sparse-embedding
    example's push (a 1M x 32 table, 192 rows), at 1M x 128 with 65,536
    rows and at nnz 0, for ``sgd``, ``sgd_mom``, ``adam`` and ``adagrad``
    (f32 weights, bf16 too for the SGD formulas), clipping off and on, wd
    0 and 1e-4: bit for bit, every untouched row of the weight and states
    unchanged, 20 calls bit-identical under
    ``set_sync_debug_mode("error")``; S1's, the plain version's and
    ``torch.optim.SparseAdam``'s / ``SGD``'s times over a sparse COO
    gradient (a yardstick only) and the bound, and S1 at one push over 1M
    and 8M rows (ratio below 1.5); the same pushes, CSR ``dot`` and its
    backward at wide-deep's shapes, and a ``Trainer`` and a ``Module`` step
    with a KVStore object on ``gpu(0)`` against ``cpu()``; the example's
    loop at its defaults (1M x 32, batch 64, 150 steps, lazy Adam): its
    loss criterion, ms a step, one S1 launch a step, and one profiled
    step (S1 once, U1 never, device busy time below one dense full-table
    Adam update's); ``factorization_machine``, ``wide_deep`` and
    ``sparse_embedding`` through ``run_example`` on ``gpu(0)``, and
    ``sparse_embedding`` at its defaults, its outcome recorded.

and then drives the RNN layer: ``mx.rnn`` cells, ``BucketSentenceIter``
and ``BucketingModule`` (`mxnet_tpu_torch/rnn/`,
`module/bucketing_module.py`) and ``gluon.rnn`` (`gluon/rnn/`), the 2x650
LM at the benchmark's widths (vocab 10000, embed 650, batch 32, SGD with
lr 1 and ``clip_gradient`` 0.25, f32, TF32 off), in one more:

24. (a) the bucketed LM (a ``FusedRNNCell`` stack, a
    ``BucketSentenceIter`` over 1,600 synthetic sentences of 5-35 tokens,
    buckets 10, 20 and 35) through ``BucketingModule.fit`` on ``gpu(0)``
    for one epoch, a second epoch timed step by step (tokens/s) and
    ``score`` (K2 and K3 once a layer and step, U1 once a step, K1 once a
    layer and eval batch; every bucket's executor holding the default
    bucket's arrays and updater), and 3 steps of the example's unrolled
    ``LSTMCell`` stack (tokens/s; none of K1-K3); (b) 2 steps over two
    buckets on ``gpu(0)`` from the seed and on ``cpu()`` from the card's
    weights, at phase 8's limits; (c) ``gluon.rnn.LSTM`` between ``Embedding`` and
    ``Dense`` at (T, B) = (35, 32), hybridized: 2 recorded steps on the
    card against the CPU (every gradient and update by relative norm to
    LSTM_GRAD_REL, two controls that must fail it), 20 timed steps
    (tokens/s, K2 and K3 once a layer and step, U1 once a step) and a
    profiled one, and the call outside ``record()``: one captured CUDA
    graph holding K1's cooperative launches (its logits against the eager
    call and the CPU's to INFER_REL; a replay one ``cudaGraphLaunch``
    with K1's kernels inside, which the wrapper's counter does not
    count); (d) K1-K3 against their plain versions at bi-lstm-sort's
    shape in both directions with the routes they took, ``gru`` and
    ``rnn_tanh`` forward and backward on the card against the CPU, and
    the op's inter-layer dropout (keep rate within 4 sigma, the output
    equal to the layers run one by one around the same mask scaled by
    1/(1-p), the same seed the same output); (e) ``word_lm`` (on its
    default ``cpu()`` and with ``--ctx tpu``), ``bi-lstm-sort``, LSTNet
    and ``rnn-time-major`` through ``run_example`` on ``gpu(0)``, each
    printing its JAX test's line, with their K1-K3 and U1 launches.

and then drives the CTC speech model of
``examples/speech_recognition/train_am.py`` (``am_symbol``:
FullyConnected + relu -> ``RNN(mode="lstm")`` -> FullyConnected ->
``CTCLoss``, blank first) at the input and alphabet of Deep Speech 2's
English model (161 spectrogram bins, 29 characters with the blank) and
the PTB LM's 650-wide LSTM, batch 32, buckets of 100, 200 and 300
frames, f32 with TF32 off, and the rest of ``ops/nn.py``, in one more:

25. (a) 960 utterances of the
    example's ``make_utterance`` (labels of 25-75 symbols, 2-4 frames a
    symbol) through ``BucketingModule`` on ``gpu(0)`` with Adam: a warm-up
    step a bucket, then one epoch of ``forward_backward`` + ``update``
    (frames/s by the host's clock between synchronizes; K2, K3 and U1
    exactly once a step); the example's decode ``Module`` at batch 1 and
    32 (K1 once a forward, softmax rows summing to 1, greedy decodes
    counted); ``torch.profiler`` over one step of the longest bucket, in
    a process of its own (busy, wall, idle share, the CTC kernels beside
    K2's and K3's); (b) 2 SGD steps from the seed over buckets 100 and 200
    on ``gpu(0)`` and on ``cpu()``: the per-sample CTC losses elementwise
    (SPEECH_LOSS_REL), every gradient and update by relative norm per
    parameter (SPEECH_GRAD_REL), and a control (each label's last symbol
    dropped on the card) that must fail both; (c) the rest of
    ``ops/nn.py`` at full size (`tools/nn_rest_sweep.py`'s card cases:
    ``Deconvolution`` at FCN's upsampling layers with bilinear and Xavier
    weights, ``CTCLoss`` at (a)'s shapes with both blank conventions, with
    and without lengths, 20 calls each, the heads, ``InstanceNorm``,
    ``LRN``, ``UpSampling`` and the resize ops at ResNet-50 stage widths)
    on ``gpu(0)`` against ``cpu()``, forward and gradients, each family
    within its limit and its control (the card's inputs rounded to bf16)
    above it; which CTC route PyTorch takes on the op's arguments; a
    hybridized ``gluon.loss.CTCLoss`` counted as uncaptured;
    (d) the six examples the slice unblocked (``svm_mnist``,
    ``kaggle-ndsb2``, ``fcn-xs``, the adversarial VAE, the CTC OCR,
    ``train_am.py``) and the eleven that ran untested before it, through
    ``run_example`` on ``gpu(0)`` at their JAX tests' arguments, each
    printing its JAX test's line, with their kernel launches;

and then drives the observability stack (telemetry, profiler and its
trace table, Monitor, xla_stats, stepprof, runprof, memprof, chaos and
threadsan) on the ResNet-50 path of phase 11 (bf16, NHWC, batch 128, the
gate on), in a process of its own (``python3 chip_smoke.py
--observability``: a fresh tracer, registry and ledger), in one more:

26. (a) ``fit`` over staged batches, 20 steps with every layer off, then
    20 with ``MXNET_STEPPROF=1`` (its sampled sync every 5 steps), runprof
    and memprof on: img/s of both and the stack's cost (OBS_OVERHEAD_LIMIT);
    the places the step synchronizes with stepprof off, none new against
    the stack off; stepprof's shares summing to 1; the sampled
    device_compute p50 within OBS_DEVICE_REL of a traced step's busy
    time; the verdict; K5 6 times a step and U1 once; compile counts
    equal on and off; (b) ``profiler`` tracing over 3 steps and
    ``device_dumps``: K5's kernels 18 times in the table, as its counter
    says (a trace that lost launches is taken again), their time within
    OBS_K5_TRACE_REL of CUDA events of the same 18 calls, the table's
    total within OBS_TABLE_BUSY_REL of the trace's busy time; (c) the
    step's counted FLOPs within OBS_FLOP_REL of the symbol's own count,
    the count without K5's analytic term outside it, and goodput and MFU
    against bf16's 989 TFLOP/s at (a)'s rate; (d) the memory ledger
    against the tensors' bytes exactly, the timeline's peak against
    ``max_memory_allocated``, the leak sentinel on a loop that keeps an
    output a step and not on a clean one, an over-allocation of the
    card's free bytes and 2 GiB as ``DeviceOOMError`` with its requested
    bytes and postmortem (the card training on after it), the same from
    the armed ``memory.oom`` chaos site; (e) a Monitor on every
    ``.*conv.*`` output with its stat against an f32 recomputation, K5 6
    times in the monitored step, and ``nan_count``'s anomaly on a NaN
    batch and not on a clean one; (f) phase 19's Gluon loop (bf16 batch
    128) for 10 steps under the Trainer's ImplicitStepper, U1 once in
    each opt_update; (g) 5 steps of (a)'s fit in another process with
    ``MXNET_TELEMETRY_DIR`` and ``MXNET_THREADSAN=1``: its event log and
    ``.prom`` snapshot, merged into a chrome trace with one step span set
    a step, threadsan's reports (none, then one for a deliberate
    inversion); (h) ``profiler_example.py`` (with and without ``--trace``)
    and ``data_and_ops.py`` through ``run_example`` under ``gpu(0)``.
    Across the phase no error is swallowed (``errors_swallowed_total``).

and then drives the whole serving stack (`mxnet_tpu_torch/serving/`:
the engine with every hook of the JAX engine, ``reqtrace``, the HTTP
server, `tools/serve_bench.py`, and the ``MXPred*`` C ABI of
`csrc/c_predict_api.cc`) on the same LM at full width, in a process of
its own (``python3 chip_smoke.py --serving``), in one more:

27. (a) an engine of 2 replicas at buckets 1..32: ``warm()`` captures one
    graph a (replica, bucket), counted in ``warmup_compiles`` (the graph
    pools' bytes printed), 100 requests from 16 clients with
    ``cold_compiles()`` 0 after, K1 exactly once a layer a served batch by
    its counter, sampled outputs against the ``Predictor`` on ``cpu()`` at
    phase 3's limits, and one profiled batch a bucket (busy and wall; one
    ``cudaGraphLaunch``, no kernel launch); (b) every completed request's
    reqtrace phases summing to its wall latency (TELESCOPE_ATOL), the p50
    and p99 phase shares and the verdict; (c) ``/predict`` with and without
    ``X-Request-Id`` (echoed, or minted), ``/metrics`` parsed
    (``serving_requests_total{status="ok"}`` equal to the requests sent,
    ``serving_batches_total`` to ``stats()``'s batches), ``/healthz`` with
    ``cold_compiles`` 0 and ``headroom_bytes``, a 404 carrying the id; (d)
    the chaos site ``serving.worker_death`` once: only the in-flight
    request fails, the worker respawns, one death and one respawn counted,
    the flight recorder dumped, the next 20 requests served; and
    ``serving.slow_request`` at 0.2 s landing in ``batch_wait``; (e)
    ``memprof.admit`` refusing an engine whose projected parameters exceed
    the card's free memory before any replica binds; (f) ``serve_bench``
    on the LM: a closed loop of 16 clients for about 5 s, then open loops
    at 0.5 and 0.9 of its rate (rps, p50/p95/p99, the p99 verdict); (g) the
    C client (`csrc/predict_client.c`) on device type 2 at batch 4 against
    the ``Predictor`` on ``gpu(0)``, and its bad-argument exit code. Across
    the phase no error is swallowed.

and then drives the breadth slice (Adam with ``multi_precision`` through
U1's ``mp_adam`` formula, held against its plain function in phase 21,
the model zoo, ``nd.linalg``, the rest of the compat ops, the file
iterators, callbacks and ``FeedForward``), in a process of its own
(``python3 chip_smoke.py --breadth``), in one more:

28. ((a), U1's ``mp_adam`` against its plain function, runs in phase
    21.) (b) ResNet-50 v1 through Gluon with ``Adam(multi_precision=True)`` in the image bench's
    configuration (NHWC, bf16, batch 128, the gate on): phase 19's loop,
    the loss falling, every weight's formula ``mp_adam``, U1 once and K5
    6 times a step, a profiled step; 2 steps at batch 4 against
    ``cpu()``, the CPU stepping from the card's gradients and states:
    masters' updates and moments to GRAD_REL, every weight its master
    rounded, Adam's bias-correction control failing; (c) each family's
    flagship (AlexNet, VGG-16, SqueezeNet 1.1, MobileNet 1.0 and v2 1.0,
    DenseNet-121 at 224, Inception-v3 at 299) served hybridized at batch
    32, f32 NCHW: one compile, then replays, each one ``cudaGraphLaunch``
    with no kernel launch; img/s; logits against eager on the card and
    on ``cpu()`` at batch 2 to INFER_REL; (d) Inception-v3 and MobileNet
    v2 trained through phase 19's loop (f32, batch 32, SGD momentum): the
    loss falling, img/s, a profiled step; 2 steps at batch 4 against
    ``cpu()`` on ZOO_CHECK_SEEDS seeds, each step's median leaf to
    GRAD_REL and its worst to ZOO_GRAD_REL, beside the CPU's own floor
    (its input moved one ulp), with a label-shifted and a momentum-less
    control; (e) every linalg op at batch 64 of 128 x 128 against
    ``cpu()``, forward and gradients, to LINALG_REL with a bf16-input
    control; ``potrf``'s NaN on a non-PD entry; a hybridized Gaussian
    log-likelihood captured or counted uncaptured, giving the eager
    value; (f) the compat ops against ``cpu()``, the negative-binomial
    samplers' moments over 2^20 draws; ``Module.fit`` fed by
    ``CSVIter``, ``LibSVMIter``, ``MNISTIter``, ``PrefetchingIter`` and
    ``ResizeIter`` against ``cpu()``; ``train_mnist.py --model-prefix``
    through ``run_example`` under ``gpu(0)``, its checkpoints loaded by
    ``model.load_checkpoint`` predicting alike on the card and the CPU;
    ``FeedForward`` on ``gpu(0)`` against ``cpu()``.

and then drives the deployment path of a Gluon user (parameter files,
``pretrained=True`` from a local file, ``export`` and ``SymbolBlock``),
``gluon.contrib.rnn``, the vision and WikiText datasets and
``contrib.autograd``, in a process of its own (``python3 chip_smoke.py
--gluon-files``), in one more:

29. (a) ResNet-50 v1 in the image bench's configuration (NHWC, bf16,
    batch 128, SGD lr 0.05 momentum 0.9, the gate on): a seeded net saved
    with ``save_parameters`` under a temporary ``root`` and built again by
    ``resnet50_v1(pretrained=True, root=...)``, its parameters and
    forward bit-equal; 1 + 3 fine-tune steps under ``record()`` and
    ``Trainer`` (img/s; K5 6 and U1 once a step, no other); the trained
    net through ``save_parameters``/``load_parameters`` and
    ``save_params``/``load_params``, bit-equal; ``export`` then
    ``SymbolBlock.imports`` served at batch 32 and 8: one capture a
    signature, none in 20 more calls of each, a call one
    ``cudaGraphLaunch`` and no kernel launch, its logits against the
    trained net's own hybridized forward to FILES_SERVE_REL with a
    control (the last BatchNorm's moving variance at 1) that must fail it;
    the exported pair through ``Predictor`` (the f32 block's
    probabilities) and ``Module`` (refused, as in the JAX package); the
    file sizes; (b) a ``Conv2DLSTMCell`` at input (16, 64, 32, 32), 64
    hidden channels, 10 steps, and an ``LSTMPCell(650, 200)`` over 35
    steps at batch 32: 2 recorded SGD steps on the card against ``cpu()``
    from the same weights, gradients and updates per parameter to
    CONTRIB_RNN_REL with a control (the second update against the first);
    ``VariationalDropoutCell``: one mask at every step, its keep rate
    within 4 sigma; (c) MNIST and CIFAR-10 files written from a seed
    through ``vision`` + ``transforms`` + ``DataLoader``, equal to numpy;
    a WikiText-2 token file through ``WikiText2`` + ``IntervalSampler``
    into one step of the 2x650 LM as ``gluon.rnn.LSTM`` (K2 and K3 once a
    layer, U1 once); ``contrib.autograd.grad_and_loss`` on the card equal
    to ``autograd``.

Phase 13 also holds K4 at head dims 160 and 256 (the CUDA-core route);
phase 24c's profiles (a training step, a graph replay) run in a process
of their own (``python3 chip_smoke.py --lstm-profile``).

Phases 3-5 are the serving main path, phase 8 the LM training one,
phase 11's gate-on steps on the card the ResNet one, phase 15's steps on
the card the attention one, phase 16's first launches the rtc one,
phase 18 the inference one, phase 19's steps on the card (its check,
the example's loop and the bf16 gate-on loop) the Gluon training one,
phase 20's two examples the nd-core one, phase 21 after its U1
check the optimizer one, phase 22's examples the detection one and phase
23's loop and examples the sparse one, phase 24 but its kernel
checks (24d) the RNN one, phase 25's training, decoding, card-vs-CPU
steps and examples (not its kernel and op checks) the speech one, and
phase 26 (but 26b's CUDA-event timing of K5) the observability one,
phase 27 the serving stack's, phase 28 the breadth one and phase 29
the Gluon files one: every kernel's launch count is set to 0 before
each and read after it.
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
run and none of K1-K6; the sparse path S1 once a push and none of
K1-K6 or N1; the RNN path K1, K2, K3 and U1, and no other; the speech
path K1, K2, K3 and U1, and no other; the observability path K5 and U1,
and no other; the serving stack's K1, and no other; the breadth path K5
(6 a gate-on step) and U1 (``mp_adam`` once a ResNet-50 step), and no
other; the Gluon files path K5 (6 a fine-tune step), U1, K2 and K3 (the
WikiText step) and K1 (the LM's deferred-init forward), and no other. A
compiled inference
forward counts K1 at each replay and at each of its capture's warm-up
runs (`compiled.WARMUP_RUNS`), so the checks of a path that compiles
add those. K5's launches in the kernels line are the ResNet path's,
the Gluon path's, the observability path's, the breadth path's and the
Gluon files path's; K1's, K2's and K3's add the RNN path's, the speech
path's and the Gluon files path's, and K1's the serving stack's;
U1's are the optimizer path's, the RNN path's, the speech path's, the
observability path's, the breadth path's and the Gluon files path's,
and the line holds
``mp_adam`` as an entry of its own (phase 21's numbers, 28b's
launches). Any
failed check exits non-zero. The last lines are the card's name and
power limit (``nvidia-smi``), one JSON line with every ported kernel's
numbers, and the result line ``{"ok": true, "device": {...}}``. Without
a CUDA device, or outside the repository, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import contextlib
import gzip
import io
import json
import logging
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import urllib.error
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
               for dt in (torch.bfloat16, torch.float32)]
            # head dims above 128 (ROADMAP C.15): the CUDA-core route
            + [(1, 4096, 4096, 8, 256, True, torch.bfloat16),
               (1, 4096, 4096, 8, 256, False, torch.float32),
               (1, 1000, 1500, 8, 160, True, torch.bfloat16),
               (1, 1500, 1000, 8, 160, False, torch.float32)])
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
# weight's (and gradient's) bytes: what it must read and write once (a
# master-copy formula reads the f32 master, never the weight)
U1_BYTES = {"sgd": lambda b: 3 * b, "sgd_mom": lambda b: 3 * b + 8,
            "mp_sgd": lambda b: 2 * b + 8, "mp_sgd_mom": lambda b: 2 * b + 16,
            "adam": lambda b: 3 * b + 16, "mp_adam": lambda b: 2 * b + 24}
U1_OPS = {"sgd": 5, "sgd_mom": 7, "mp_sgd": 5, "mp_sgd_mom": 7, "adam": 14,
          "mp_adam": 14}
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
# phase 23: the sparse slice. S1 (the lazy row-sparse update) at
# examples/sparse/sparse_embedding/train.py's push (a 1M x 32 table, 192
# stored rows: batch 64 x 3 ids, deduplicated), at a wide one (1M x 128,
# 65,536 rows) and at nnz 0; every formula, f32 weights (bf16 too for the
# two SGD formulas), clipping off and on, wd 0 and 1e-4
S1_SHAPES = [(1_000_000, 32, 192), (1_000_000, 128, 65_536),
             (1_000_000, 32, 0)]
S1_CASES = [("sgd", torch.float32), ("sgd", torch.bfloat16),
            ("sgd_mom", torch.float32), ("sgd_mom", torch.bfloat16),
            ("adam", torch.float32), ("adagrad", torch.float32)]
S1_FLAGS = [(None, 0.0), (None, 1e-4), (0.75, 0.0), (0.75, 1e-4)]
S1_KW = {"lr": 0.05, "rescale_grad": 0.5, "momentum": 0.9, "beta1": 0.9,
         "beta2": 0.999, "epsilon": 1e-8}
S1_CALLS = 20
# the same push over tables of 1M and 8M rows: the update is O(nnz)
S1_TABLES = (1_000_000, 8_000_000)
S1_TABLE_RATIO = 1.5
# bytes a stored value moves (the f32 gradient value, the weight (w bytes)
# read and written, the f32 states read and written) and f32 operations
S1_BYTES = {"sgd": lambda w: 4 + 2 * w, "sgd_mom": lambda w: 12 + 2 * w,
            "adam": lambda w: 20 + 2 * w, "adagrad": lambda w: 12 + 2 * w}
S1_OPS = {"sgd": 5, "sgd_mom": 7, "adam": 15, "adagrad": 10}
# the example's loop at its defaults, on gpu(0)
SPARSE_ROWS, SPARSE_DIM, SPARSE_BATCH = 1_000_000, 32, 64
SPARSE_HOT, SPARSE_STEPS, SPARSE_LR = 500, 150, 0.05
# card against CPU: 5 pushes of about 192 rows over a 100k x 32 table
SPARSE_CHECK_ROWS, SPARSE_CHECK_PUSHES = 100_000, 5
SPARSE_RTOL, SPARSE_ATOL = 1e-6, 1e-7
# wide-deep's CSR dot: batch 64 x 2000 features, 10 stored a row, x 2000 x 8
CSR_SHAPE, CSR_PER_ROW, CSR_COLS = (64, 2000), 10, 8
# index_add_ sums with atomics, in an order that varies from run to run
CSR_RTOL, STEP_RTOL = 1e-5, 1e-5
# the examples at the arguments of tests/test_examples.py (the two Module
# examples bind to mx.cpu() unless given --ctx tpu, which is cuda:0), and
# sparse_embedding at its defaults
SPARSE_EXAMPLES = [
    ("factorization_machine", "sparse/factorization_machine/train.py",
     ["--num-epochs", "15", "--num-examples", "2400", "--num-features",
      "200", "--lr", "0.01", "--ctx", "tpu"], "final val accuracy", 0.6),
    ("wide_deep", "sparse/wide_deep/train.py",
     ["--num-epochs", "6", "--num-examples", "1200", "--num-sparse", "400",
      "--ctx", "tpu"], "final val accuracy", 0.7),
    ("sparse_embedding", "sparse/sparse_embedding/train.py",
     ["--rows", "100000", "--steps", "80"], "SPARSE EMBEDDING OK", None)]
# the bench's inference function in phase 18: rounds of calls x iters
INFER_ITERS, INFER_CALLS, INFER_ROUNDS = 50, 2, 2
PEAK_TF32_FLOPS = 495e12
# phase 24, the RNN layer: the bucketed word LM of examples/rnn/word_lm at
# the benchmark's widths (a FusedRNNCell stack; BucketSentenceIter over
# RNN_SENTENCES synthetic sentences of RNN_LENGTHS tokens, buckets
# RNN_BUCKETS, batch 32), UNROLLED_STEPS steps of the example's own
# unrolled LSTMCell stack, and gluon.rnn.LSTM between an Embedding and a
# Dense at the same widths (GLUON_LM_WARMUP + GLUON_LM_STEPS steps)
RNN_BUCKETS = (10, 20, 35)
RNN_SENTENCES, RNN_LENGTHS = 1600, (5, 35)
UNROLLED_STEPS = 3
GLUON_LM_WARMUP, GLUON_LM_STEPS = 2, 20
# the Gluon LSTM's 2 f32 steps on the card against the CPU, each
# parameter's gradient and update by relative norm: near the geometric
# middle of the sound readings (<= 1.4e-4) and two controls that must
# fail it (K3's dWh product zeroed on the card; the card's second update
# against the CPU's first: 1.0 and 1.5), all printed in phase 24; a TF32
# product in the layer reads about 1e-3 and fails it
LSTM_GRAD_REL = 2e-3
# phase 24b from 24a's trained weights: no f32 run holds phase 8's limits
# against the same 2 steps in f64 there (in some trained states the CPU's
# own falls outside them), and the f32 runs' distances to f64 scatter over
# orders of magnitude with the state, the CPU's and the card's apart
# (mxnet_tpu_torch/tools/rnn_rounding_study.py; readings in PERF.md). Those
# distances are printed; each parameter of the card must lie this many
# times nearer the f64 run than the control, the card with its last step
# dropped (the study's smallest margin is in PERF.md)
RNN_CONTROL = 10.0
# K1-K3 at bi-lstm-sort's shape (T, B, embed, hidden), both directions
RNN_SORT_SHAPE = (6, 100, 16, 64)
# gru and rnn_tanh (2 layers, bidirectional, the LM's widths) on the card
# against the CPU: the largest difference over the largest magnitude
RNN_MODE_REL = 1e-5
RNN_DROPOUT = 0.5
WORD_LM_ARGS = ["--num-epochs", "1", "--max-sentences", "300",
                "--batch-size", "25", "--num-hidden", "32", "--num-embed",
                "16", "--data", "/nonexistent"]
RNN_PATH = ("fused_lstm", "fused_lstm_train", "lstm_bwd_recurrence",
            "multi_tensor_update")
# (key, example, arguments, the line its JAX test asserts, the kernels of
# RNN_PATH it must launch: the others it must not). word_lm runs on
# mx.cpu() unless --ctx tpu; its unrolled LSTMCells are elementwise ops
RNN_EXAMPLES = [
    ("word_lm", "rnn/word_lm/train.py", WORD_LM_ARGS,
     "final train perplexity", ()),
    ("word_lm_tpu", "rnn/word_lm/train.py", WORD_LM_ARGS + ["--ctx", "tpu"],
     "final train perplexity", ("multi_tensor_update",)),
    ("bi_lstm_sort", "bi-lstm-sort/train_sort.py",
     ["--num-examples", "2000", "--num-epochs", "20"], "token accuracy",
     RNN_PATH),
    ("lstnet", "multivariate_time_series/train_lstnet.py", [],
     "LSTNET FORECAST OK", ("multi_tensor_update",)),
    ("rnn_time_major", "rnn-time-major/readme_bench.py", ["--steps", "10"],
     "RNN TIME-MAJOR OK", ("fused_lstm_train", "lstm_bwd_recurrence",
                           "multi_tensor_update"))]

# phase 25, the CTC speech model of examples/speech_recognition/train_am.py
# (am_symbol: FullyConnected + relu -> RNN(lstm) -> FullyConnected ->
# CTCLoss, blank first; BucketingModule over utterance-length buckets,
# Adam) at the input and alphabet of Deep Speech 2's English model
# (arXiv:1512.02595: 161 spectrogram bins, 29 characters with the blank)
# and the repository's widest LSTM (the PTB LM's 650), batch 32, f32. The
# example's make_utterance: labels of SPEECH_LABELS symbols, 2-4 frames a
# symbol, so SPEECH_UTTS utterances fill the three buckets
SPEECH_FEAT, SPEECH_PHONES, SPEECH_HIDDEN = 161, 29, 650
SPEECH_BATCH = 32
SPEECH_BUCKETS = (100, 200, 300)
SPEECH_LABELS = (25, 75)
SPEECH_UTTS = 960
SPEECH_OPT = {"learning_rate": 1e-3}
SPEECH_DECODE = 6                   # utterances decoded one at a time
# the speech model's LSTM layer (I = H = 650) at each bucket with B=32:
# K1 held to LSTM_ATOL in phase 2; K2, K3 and the layer's gradients held
# and timed in phase 7. Decoding one utterance of the longest runs K1
# alone, held in phase 2
SPEECH_LSTM_SHAPES = [(t, SPEECH_BATCH, SPEECH_HIDDEN, SPEECH_HIDDEN)
                      for t in SPEECH_BUCKETS]
SPEECH_DECODE_SHAPE = (max(SPEECH_BUCKETS), 1, SPEECH_HIDDEN, SPEECH_HIDDEN)
# the profiled speech step's process: start, build nothing, 2 steps and
# up to PROFILE_ATTEMPTS traces
SPEECH_PROFILE_TIMEOUT_S = 300
# 25b: 2 SGD steps from the seed on the card against the CPU. The
# per-sample losses' largest relative difference, and each parameter's
# gradient and update by relative norm: between the sound readings and the
# control (each label's last symbol dropped on the card), both in PERF.md
SPEECH_CHECK_OPT = {"learning_rate": 0.01}
SPEECH_LOSS_REL = 1e-4
SPEECH_GRAD_REL = 2e-3
# 25d: (key, example, arguments of its JAX test, the line it asserts): the
# six examples of this slice, then the eleven that ran on the port
# untested before it
SPEECH_EXAMPLES = [
    ("svm_mnist", "svm_mnist/train_svm.py",
     ["--num-examples", "800", "--num-epochs", "6"], "final svm accuracy"),
    ("kaggle_ndsb2", "kaggle-ndsb2/train_ndsb2.py",
     ["--num-examples", "200", "--num-epochs", "6"], "final NDSB2 val CRPS"),
    ("fcn_xs", "fcn-xs/train_fcn.py",
     ["--num-examples", "32", "--num-epochs", "10"], "FCN SEGMENTATION OK"),
    ("adversarial_vae", "mxnet_adversarial_vae/vaegan.py",
     ["--num-examples", "512", "--num-epochs", "6", "--batch-size", "32"],
     "final VAE-GAN pixel recon MSE"),
    ("ctc_ocr", "ctc/train_ctc_ocr.py",
     ["--num-examples", "800", "--num-epochs", "25"], "sequence accuracy"),
    ("speech_am", "speech_recognition/train_am.py", [], "SPEECH AM OK")]
A14_EXAMPLES = [
    ("train_mnist", "image-classification/train_mnist.py",
     ["--num-epochs", "4", "--num-examples", "600", "--batch-size", "50"],
     "final validation"),
    ("nce_loss", "nce-loss/train_nce.py", [], "rank-1 accuracy"),
    ("neural_style", "neural-style/neural_style.py",
     ["--size", "32", "--iters", "40"], "NEURAL STYLE OK"),
    ("actor_critic", "reinforcement-learning/parallel_actor_critic.py",
     ["--updates", "400"], "PARALLEL ACTOR-CRITIC OK"),
    ("stochastic_depth", "stochastic-depth/train_sd.py",
     ["--num-epochs", "8"], "STOCHASTIC DEPTH OK"),
    ("captcha", "captcha/train_captcha.py", ["--num-epochs", "6"],
     "CAPTCHA OK"),
    ("sgld", "bayesian-methods/sgld_regression.py", [], "SGLD OK"),
    ("memcost", "memcost/memonger_demo.py", [], "MEMCOST REMAT OK"),
    ("capsnet", "capsnet/train_capsnet.py", ["--num-epochs", "6"],
     "CAPSNET OK"),
    ("dec", "deep-embedded-clustering/dec.py", [], "DEC OK"),
    ("text_cnn_zh", "cnn_chinese_text_classification/text_cnn_zh.py",
     ["--num-examples", "800", "--num-epochs", "4"],
     "final chinese text-cnn accuracy")]


# device_profile's attempts, the k-th a pause of k * PROFILE_PAUSE_S after
# the one before: the tracer returned empty traces at phase 21a in two runs
# on an H100 at 700 W, three in a row in one and six a second apart in the
# other (U1's time then falls back to CUDA events)
PROFILE_ATTEMPTS, PROFILE_PAUSE_S = 6, 1.0


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def run_own_process(flag, timeout, log_prefix=None, log_as="%s", env=None):
    """This script again, as ``python3 chip_smoke.py <flag>``, in a
    process of its own (a fresh tracer, registry and allocator), after a
    synchronize and ``empty_cache`` here. Its standard-output lines that
    start with ``log_prefix`` are logged through ``log_as``; it must exit
    0; returns its last line's JSON."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                         capture_output=True, text=True, timeout=timeout,
                         env=env)
    if log_prefix is not None:
        for line in out.stdout.splitlines():
            if line.startswith(log_prefix):
                log(log_as % line)
    check(out.returncode == 0, "the %s process exited %d: %s"
          % (flag, out.returncode, out.stderr[-4000:]))
    return json.loads(out.stdout.splitlines()[-1])


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


def queued_call_ms(fn, reps):
    """Mean device time of one call of ``fn`` in ms, by CUDA events, each
    call queued alone while the card sleeps (QUEUE_CYCLES): for a wrapper
    whose calls wait for the card's earlier ones (U1's pinned ring), where
    ``time_ms``'s queue of calls would time the host."""
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_profile(fn, attempts=PROFILE_ATTEMPTS, complete=None):
    """Run ``fn`` under torch.profiler. Returns the profiled wall time in
    ms and {kernel name: [launches, device ms]}; the kernels are empty
    when the profiler saw no device activity. A run whose trace holds no
    device activity at all, or that ``complete`` (a test of the kernels)
    rejects, is run again, up to ``attempts`` runs, 1, 2, ... s apart: the
    tracer now and then returns an empty trace, or one that lost part of
    the run, and has done so three times in a row."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(attempts):
        if attempt:
            time.sleep(PROFILE_PAUSE_S * attempt)
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
    call of ``fn`` over ``t`` steps, and its device µs a step. A trace
    without it is taken again (``device_profile``): the tracer has
    returned traces of K3's call that held its other kernels and not the
    recurrence's, more often the more traces the process had taken
    before, on an H100 at 700 W."""
    name = recurrence_kernel(plan, kernel)
    _, kern = device_profile(fn, complete=lambda kern: any(
        name in k for k in kern))
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
    shapes, the speech model's, the step route's and a ragged one; each
    call's route against its plan; bitwise determinism at B=32."""
    fused_lstm, plain = ops.fused_lstm, ops.fused_lstm_plain
    rows = []
    worst = 0.0
    served = [(SEQ, b, EMBED, HIDDEN) for b in SERVED_BATCHES]
    shapes = served + EXTRA_SHAPES + SPEECH_LSTM_SHAPES + [
        SPEECH_DECODE_SHAPE, STEP_ROUTE_SHAPE, RAGGED]
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
    """The Predictor's first forward compiles its signature (on the card:
    the warm-up runs, the capture and a replay), the second is one replay
    of the captured graph, with K1 once a layer."""
    n = 4
    pred = mx.Predictor(sym_json, params, ctx=ctx,
                        input_shapes={"data": (n, SEQ)})
    toks = tokens(rng, n)
    counts = mx.compiled.compile_counts()
    before = mx.ops.fused_lstm.launches
    pred.forward(data=toks)
    first = mx.ops.fused_lstm.launches - before
    before = mx.ops.fused_lstm.launches
    pred.forward(data=toks)
    out = pred.get_output(0)
    grew = mx.ops.fused_lstm.launches - before
    after = mx.compiled.compile_counts()
    counts = {k: after[k] - counts[k] for k in after}
    entry = next(iter(pred._exec._program._cache.values()))
    if ctx.device_type == "gpu":
        check(counts == {"compiles": 1, "cache_hits": 1, "retraces": 0,
                         "uncaptured": 0}
              and isinstance(entry, mx.compiled._Graph),
              "the served forward was not one captured graph: compile "
              "counts %s" % counts)
        check(first == LAYERS * (mx.compiled.WARMUP_RUNS + 1)
              and grew == LAYERS,
              "fused_lstm launched %d times at the first forward (warm-ups "
              "and a replay) and %d at a replay, want %d and %d (one per "
              "layer)" % (first, grew,
                          LAYERS * (mx.compiled.WARMUP_RUNS + 1), LAYERS))
    check_probs(out, n, "Predictor output")
    err = compare(out, ref(toks), "Predictor output")
    log("phase 3 predictor %s" % json.dumps({
        "rows": n, "compile_counts": counts,
        "fused_lstm_launches_first_forward": first,
        "fused_lstm_launches_per_replay": grew,
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
    # before the CPU reference runs: its predictors' compiles count in
    # the process-wide compile count that cold_compiles reads
    st = engine.stats()
    for toks, (out, _) in zip(reqs, results):
        check_probs(out, toks.shape[0], "engine output")
    sample = range(0, ENGINE_REQUESTS, ENGINE_REQUESTS // 8)
    err = max(compare(results[i][0], ref(reqs[i]), "engine request %d" % i)
              for i in sample)
    lat = np.array([lat for _, lat in results]) * 1e3
    rows = sum(r.shape[0] for r in reqs)
    check(st["requests"].get("ok") == ENGINE_REQUESTS,
          "engine request counts %s" % st["requests"])
    check(st["cold_compiles"] == 0 and st["warmup_compiles"] == len(
        engine.buckets), "the engine compiled %d signatures at warm-up "
          "and %d under load" % (st["warmup_compiles"], st["cold_compiles"]))
    log("phase 4 engine %s" % json.dumps({
        "requests": ENGINE_REQUESTS, "clients": ENGINE_CLIENTS,
        "rows": rows, "wall_s": wall,
        "requests_per_s": ENGINE_REQUESTS / wall,
        "tokens_per_s": rows * SEQ / wall,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "warmup_s": st["warmup_seconds"],
        "warmup_compiles": st["warmup_compiles"],
        "cold_compiles": st["cold_compiles"],
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
    """Where a served forward's device time goes, at the top bucket: the
    forward is one replay of its captured graph, so the host makes one
    ``cudaGraphLaunch`` and no kernel launch, and the trace shows the
    graph's kernels, K1 once a layer among them."""
    n = ENGINE_MAX_BATCH
    pred = mx.Predictor(sym_json, params, ctx=mx.gpu(0),
                        input_shapes={"data": (n, SEQ)})
    toks = tokens(rng, n)
    pred.forward(data=toks)      # the capture
    pred.forward(data=toks)      # warm: a first replay
    # a trace that lost K1's launches (seen once on the process's first
    # profile) is taken again, as the other phases' profiles are
    wall, kern = device_profile(
        lambda: pred.forward(data=toks),
        complete=lambda k: bool(kernel_share(k, K1_KERNELS, 1.0)["launches"]))
    busy = sum(ms for _, ms in kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:6]
    k1 = kernel_share(kern, K1_KERNELS, busy)
    host = call_profile(lambda: pred.forward(data=toks))
    log("phase 6 profile %s" % json.dumps({
        "rows": n, "forward_wall_ms": wall, "device_busy_ms": busy,
        "device_idle_share": (1 - busy / wall) if kern else None,
        "k1": k1, "runtime_calls": host["runtime_calls"],
        "top_kernels": [{"kernel": k, "launches": c, "ms": ms,
                         "share": ms / busy} for k, (c, ms) in top]}))
    check(list(k1["launches"].values()) == [LAYERS]
          and "lstm_persistent" in next(iter(k1["launches"])),
          "a served forward's profile shows K1 kernels %s, want one "
          "lstm_persistent launch per layer (%d)" % (k1["launches"], LAYERS))
    calls = host["runtime_calls"]
    check(calls.get("cudaGraphLaunch") == 1
          and not any("LaunchKernel" in k for k in calls),
          "a served forward made host calls %s, want one cudaGraphLaunch "
          "and no kernel launch" % calls)


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
    the plain backward, at T=35, B in {8, 32}, I=H=650, at the speech
    model's shapes and a ragged shape; kernel, plain and cuDNN times with
    each kernel's bound. K2 and
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
    shapes = [(SEQ, b, EMBED, HIDDEN) for b in TRAIN_BATCHES] + \
        SPEECH_LSTM_SHAPES + [RAGGED]
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
                if t == SEQ:    # at the speech shapes: by route only
                    launches, us = recurrence_profile(
                        lambda: ops.fused_lstm_train(*args), t, plan, "k2")
                    row.update(k2_recurrence_launches_per_call=launches,
                               k2_recurrence_us_per_step=us)
                    # K3's recurrence kernel: one launch a call on its route
                    launches, us = recurrence_profile(
                        lambda: ops.lstm_bwd_recurrence(*bwd_args), t,
                        bplan, "k3")
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
    compiles = mx.compiled.compile_counts()["compiles"]
    (_, eval_ppl), = fit_mod.score(lm_iter(mx, rng, EVAL_BATCHES),
                                   mx.metric.Perplexity())
    k1_by_score = mx.ops.fused_lstm.launches - k1_before
    score_compiles = mx.compiled.compile_counts()["compiles"] - compiles
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
        "k1_launches_by_score": k1_by_score,
        "score_compiles": score_compiles}
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
    for attempt in range(PROFILE_ATTEMPTS):   # see device_profile
        if attempt:
            time.sleep(PROFILE_PAUSE_S * attempt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        if any(str(getattr(e, "device_type", "")).endswith("CUDA")
               for e in prof.key_averages()):
            break
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
    the eight longest kernels (launches, device ms). A trace without
    device activity is taken again, as ``device_profile`` does."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(PROFILE_ATTEMPTS):
        if attempt:
            time.sleep(PROFILE_PAUSE_S * attempt)
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
        if events:
            break
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
    """A step of PyTorch's library computing the update over the same
    tensors (never on the port's path): fused ``torch.optim.SGD`` or
    ``Adam``; for ``mp_adam`` fused ``Adam`` over the f32 masters, then
    ``torch._foreach_copy_`` of the masters into the bf16 weights."""
    if formula == "mp_adam":
        params = [st[-1].clone().requires_grad_() for _, _, st in lists]
        for p, (_, g, _) in zip(params, lists):
            p.grad = g.float()
        weights = [w.clone() for w, _, _ in lists]
        opt = torch.optim.Adam(params, lr=1e-3, weight_decay=1e-4,
                               fused=True)

        def step():
            opt.step()
            with torch.no_grad():
                torch._foreach_copy_(weights, params)
        return step
    params = []
    for w, g, _ in lists:
        p = w.clone().requires_grad_()
        p.grad = g.clone()
        params.append(p)
    if formula == "adam":
        return torch.optim.Adam(params, lr=1e-3, weight_decay=1e-4,
                                fused=True).step
    return torch.optim.SGD(params, lr=0.1, momentum=0.9, weight_decay=1e-4,
                           fused=True).step


def phase_u1(shapes):
    """Phase 21a: U1 against its plain version on the card at ResNet-50's
    parameter shapes, for every formula and weight dtype, clipping off and
    on, rescale_grad 0.25, per-tensor lrs and wds, 3 updates each (a
    master-copy formula's weights and states bit for bit); U1_CALLS calls
    from the same inputs bit-identical in weights and states for (a)'s
    formula, (b)'s and mp_adam on bf16 weights; their kernel, plain and
    library times and the bound."""
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
                differ = sum(int((a != b).sum())
                             for (w, _, st), (w0, _, st0) in zip(got, want)
                             for a, b in zip((w,) + st, (w0,) + st0))
                worst = max(worst, err)
                rows.append({"formula": formula, "dtype": str(dtype)[6:],
                             "clip": clip, "max_abs_err": err,
                             "over_tolerance": bad,
                             "values_differing": differ})
                if bad:
                    fails.append("%s %s clip %s: %d values" % (
                        formula, dtype, clip, bad))
                if differ and formula.startswith("mp_"):
                    fails.append("%s %s clip %s: %d values not bit for bit"
                                 % (formula, dtype, clip, differ))
                del got, want
    timed = {}
    for key, formula, dtype in (("a", "mp_sgd_mom", torch.bfloat16),
                                ("b", "adam", torch.float32),
                                ("c", "mp_adam", torch.bfloat16)):
        start = u1_lists(formula, dtype, shapes, SEED + 211)
        lists = u1_clone(start)
        buffers = UpdateBuffers()
        first, same = None, True
        for _ in range(U1_CALLS):
            for (w, _, st), (w0, _, st0) in zip(lists, start):
                w.copy_(w0)
                for a, b in zip(st, st0):
                    a.copy_(b)
            multi_tensor_update(formula, *u1_args(lists), lrs, wds,
                                clip_gradient=1.0, buffers=buffers, **kw)
            out = torch.cat([t.float().flatten() for w, _, st in lists
                             for t in (w,) + st])
            if first is None:
                first = out
            else:
                same = same and torch.equal(out, first)
        del first, out

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
        if seen:
            count, dev_ms = seen[0]
            ms, timed_by = dev_ms / count, "profiler"
        else:       # only empty traces: CUDA events, the lr/wd copy in too
            count, ms, timed_by = 0, queued_call_ms(kernel, 5), "events"
        timed[key] = {"formula": formula, "dtype": str(dtype)[6:],
                      "tensors": n, "values": values,
                      "bytes_a_value": U1_BYTES[formula](
                          2 if dtype == torch.bfloat16 else 4),
                      "bit_identical_calls": same, "ms": ms,
                      "timed_by": timed_by, "profiled_launches": count,
                      "call_wall_ms": call_ms,
                      "plain_ms": time_ms(plain, 3),
                      "library_ms": time_ms(library, 20),
                      "bound_ms": bound, "bound_by": by}
        if not same:
            fails.append("%s: %d calls from the same inputs differ"
                         % (formula, U1_CALLS))
        del start, lists, library
    summary = {"shapes": n, "values": values, "checks": rows,
               "max_abs_err": worst, "timed": timed,
               "max_abs_err_by_formula": {
                   f: max(r["max_abs_err"] for r in rows
                          if r["formula"] == f) for f in FORMULAS},
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

    def start():
        torch.cuda.synchronize()
        state["prof"] = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
        state["prof"].start()
        state["t0"] = time.perf_counter()

    def step(self, *args, **kwargs):
        out = trainer_step(self, *args, **kwargs)
        k = len(rec["times"])
        rec["times"].append(time.perf_counter())
        if profile_after is not None and k + 1 == profile_after:
            state["tries"] = 1
            start()
        elif "prof" in state:
            torch.cuda.synchronize()
            wall = (time.perf_counter() - state["t0"]) * 1e3
            prof = state.pop("prof")
            prof.stop()
            if state["tries"] < PROFILE_ATTEMPTS and not any(
                    str(getattr(e, "device_type", "")).endswith("CUDA")
                    for e in prof.key_averages()):
                state["tries"] += 1         # an empty trace: the next one
                start()
            else:
                rec["profile"] = iteration_profile(prof, wall)
        return out

    mx.gluon.Trainer.step = step
    try:
        yield rec
    finally:
        mx.gluon.Trainer.step = trainer_step
        if "prof" in state:             # the run ended inside a retry
            state.pop("prof").stop()


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



def s1_inputs(formula, dtype, shape, seed, device="cuda"):
    """(weight, states, values, indices) of one push on ``device`` from a
    seed: states positive (Adam's variance), unique row ids."""
    from mxnet_tpu_torch.ops.sparse_update import FORMULAS
    rows, d, nnz = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((rows, d), generator=gen, device=device).to(dtype)
    states = tuple(torch.rand((rows, d), generator=gen, device=device) + 0.1
                   for _ in range(FORMULAS[formula][1]))
    idx = torch.randperm(rows, generator=gen, device=device)[:nnz]
    vals = torch.randn((nnz, d), generator=gen, device=device) * 3
    return w, states, vals, idx


def s1_bound(formula, dtype, d, nnz):
    """(ms, "bytes" | "operations") of one S1 call: each touched value
    read and written once, the row ids read once."""
    w = 2 if dtype == torch.bfloat16 else 4
    values = d * nnz
    return bound_of((values * S1_BYTES[formula](w) + 8 * nnz)
                    / PEAK_BYTES_PER_S * 1e3,
                    values * S1_OPS[formula] / PEAK_F32_FLOPS * 1e3)


def library_sparse(formula, w, vals, idx):
    """One PyTorch optimizer step over a ``torch.sparse_coo_tensor``
    gradient with the same rows (``SparseAdam`` for adam, ``SGD`` with
    momentum 0 otherwise): a yardstick of time only, whose formulas
    differ; never on the port's path."""
    p = torch.nn.Parameter(w.clone())
    p.grad = torch.sparse_coo_tensor(idx[None], vals, tuple(w.shape))
    if formula == "adam":
        return torch.optim.SparseAdam([p], lr=S1_KW["lr"])
    return torch.optim.SGD([p], lr=S1_KW["lr"])


def phase_s1(mx, device="cuda"):
    """Phase 23a: S1 against its plain version on the card at S1_SHAPES
    for every formula and weight dtype, clipping off and on, wd 0 and
    1e-4: the weight and states bit for bit, every untouched row
    bit-identical to its value before the push; S1_CALLS calls from the
    same inputs bit-identical under set_sync_debug_mode("error"); S1's
    CUDA-event ms, the plain version's, the bound and
    SparseAdam's / SGD's over a sparse COO gradient at each shape; S1 at
    one push over tables of 1M and 8M rows."""
    from mxnet_tpu_torch.ops.sparse_update import (sparse_row_update,
                                                   sparse_row_update_plain)
    checks, fails = [], []
    for shape in S1_SHAPES:
        for formula, dtype in S1_CASES:
            for clip, wd in S1_FLAGS:
                w, states, vals, idx = s1_inputs(formula, dtype, shape,
                                                 SEED + 230, device)
                w0, s0 = w.clone(), tuple(s.clone() for s in states)
                ref_w, ref_s = w.clone(), tuple(s.clone() for s in states)
                before = sparse_row_update.launches
                sparse_row_update(formula, w, vals, idx, states, wd=wd,
                                  clip_gradient=clip, **S1_KW)
                sparse_row_update_plain(formula, ref_w, vals, idx, ref_s,
                                        wd=wd, clip_gradient=clip, **S1_KW)
                launched = sparse_row_update.launches - before
                rest = torch.ones(shape[0], dtype=torch.bool, device=device)
                rest[idx] = False
                same = torch.equal(w, ref_w) and all(
                    torch.equal(a, b) for a, b in zip(states, ref_s))
                kept = torch.equal(w[rest], w0[rest]) and all(
                    torch.equal(a[rest], b[rest])
                    for a, b in zip(states, s0))
                err = float((w.float() - ref_w.float()).abs().max())
                row = {"shape": shape, "formula": formula,
                       "dtype": str(dtype)[6:], "clip": clip, "wd": wd,
                       "bit_equal": same, "untouched_kept": kept,
                       "launches": launched, "max_abs_err": err}
                checks.append(row)
                if not (same and kept and launched == int(shape[2] > 0)):
                    fails.append(row)
                del w, states, w0, s0, ref_w, ref_s
    timed = []
    for shape in S1_SHAPES[:2]:
        for formula in ("adam", "sgd"):
            w0, s0, vals, idx = s1_inputs(formula, torch.float32, shape,
                                          SEED + 231, device)
            outs = []
            for _ in range(S1_CALLS):
                w, states = w0.clone(), tuple(s.clone() for s in s0)
                torch.cuda.set_sync_debug_mode("error")
                try:
                    sparse_row_update(formula, w, vals, idx, states, **S1_KW)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                outs.append(torch.cat([w.flatten()] +
                                      [s.flatten() for s in states]))
            identical = all(torch.equal(o, outs[0]) for o in outs)
            del outs
            w, states = w0.clone(), tuple(s.clone() for s in s0)
            library = library_sparse(formula, w, vals, idx)
            bound, by = s1_bound(formula, torch.float32, shape[1], shape[2])
            row = {"shape": shape, "formula": formula, "dtype": "float32",
                   "bit_identical_calls": identical,
                   "ms": time_ms(lambda: sparse_row_update(
                       formula, w, vals, idx, states, **S1_KW), S1_CALLS),
                   "plain_ms": time_ms(lambda: sparse_row_update_plain(
                       formula, w, vals, idx, states, **S1_KW), S1_CALLS),
                   "library_ms": time_ms(library.step, S1_CALLS),
                   "library": type(library).__name__,
                   "bound_ms": bound, "bound_by": by}
            timed.append(row)
            if not identical:
                fails.append(row)
            del w0, s0, w, states, library
    tables = {}
    for rows in S1_TABLES:
        shape = (rows,) + S1_SHAPES[0][1:]
        w, states, vals, idx = s1_inputs("adam", torch.float32, shape,
                                         SEED + 232, device)
        tables[rows] = time_ms(lambda: sparse_row_update(
            "adam", w, vals, idx, states, **S1_KW), S1_CALLS)
        del w, states
    ratio = tables[S1_TABLES[1]] / tables[S1_TABLES[0]]
    summary = {"checks": len(checks), "failed": fails, "timed": timed,
               "table_ms": tables, "table_ratio": ratio,
               "max_abs_err": max(r["max_abs_err"] for r in checks)}
    log("phase 23 S1 vs plain %s" % json.dumps(summary))
    check(not fails, "S1 against its plain version: %s" % fails[:3])
    check(ratio < S1_TABLE_RATIO, "S1 at one push over %d rows took %.4f ms "
          "and over %d rows %.4f ms: ratio %.2f, want below %.1f"
          % (S1_TABLES[0], tables[S1_TABLES[0]], S1_TABLES[1],
             tables[S1_TABLES[1]], ratio, S1_TABLE_RATIO))
    torch.cuda.empty_cache()
    return summary


def sparse_embedding_setup(mx, rng):
    """The example's table, store and Adam updater on gpu(0)."""
    from mxnet_tpu_torch.ndarray import sparse
    ctx = mx.gpu(0)
    hot = rng.choice(SPARSE_ROWS, SPARSE_HOT, replace=False)
    cluster = rng.randint(0, 8, SPARSE_HOT)
    kv = mx.kv.create("local")
    kv.init("emb", mx.nd.array(rng.randn(SPARSE_ROWS, SPARSE_DIM)
                               .astype(np.float32) * 0.05, ctx=ctx))
    opt = mx.optimizer.Adam(learning_rate=SPARSE_LR, rescale_grad=1.0)
    kv._set_updater(mx.optimizer.get_updater(opt))
    out_buf = sparse.zeros("row_sparse", (SPARSE_ROWS, SPARSE_DIM), ctx=ctx)
    return hot, cluster, kv, opt, out_buf


def sparse_embedding_step(mx, rng, hot, cluster, kv, out_buf):
    """One step of examples/sparse/sparse_embedding/train.py's loop, as it
    is written (row_sparse_pull, the gathered rows' forward and backward,
    the row-sparse gradient pushed into lazy Adam): its loss."""
    from mxnet_tpu_torch.ndarray import sparse
    ctx = mx.gpu(0)
    ci = rng.randint(0, 8, SPARSE_BATCH)
    a = hot[np.array([rng.choice(np.where(cluster == c)[0]) for c in ci])]
    b = hot[np.array([rng.choice(np.where(cluster == c)[0]) for c in ci])]
    n = hot[rng.randint(0, SPARSE_HOT, SPARSE_BATCH)]
    rows = np.unique(np.concatenate([a, b, n]))
    remap = {r: i for i, r in enumerate(rows)}
    kv.row_sparse_pull("emb", out=out_buf, row_ids=mx.nd.array(
        rows.astype(np.float32), ctx=ctx))
    W = mx.nd.array(np.asarray(out_buf._ensure_aux()["values"]), ctx=ctx)
    W.attach_grad()
    ia, ib, inn = (mx.nd.array(np.array([remap[r] for r in s], np.float32),
                               ctx=ctx) for s in (a, b, n))
    with mx.autograd.record():
        ea, eb, en = (mx.nd.take(W, i) for i in (ia, ib, inn))
        pos = mx.nd.sum(ea * eb, axis=1)
        neg = mx.nd.sum(ea * en, axis=1)
        loss = mx.nd.relu(1.0 - pos + neg).mean()
    loss.backward()
    kv.push("emb", sparse.row_sparse_array(
        (W.grad.asnumpy(), rows.astype(np.int64)),
        shape=(SPARSE_ROWS, SPARSE_DIM), ctx=ctx))
    return float(loss.asnumpy())


def phase_sparse_loop(mx):
    """Phase 23b: the sparse-embedding loop at the example's defaults on
    gpu(0) (1M x 32 table, batch 64, 500 hot rows, 150 steps, lazy Adam
    at lr 0.05 through kv.create("local")): the example's loss criterion,
    ms a step on the host's clock bracketed by synchronize, one S1 launch
    a step; one more step under torch.profiler (S1 once, U1 never, its
    device busy time below one dense full-table Adam update's device
    time on the same table)."""
    s1, u1 = mx.ops.sparse_row_update, mx.ops.multi_tensor_update
    rng = np.random.RandomState(0)
    hot, cluster, kv, opt, out_buf = sparse_embedding_setup(mx, rng)
    before = s1.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [sparse_embedding_step(mx, rng, hot, cluster, kv, out_buf)
              for _ in range(SPARSE_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / SPARSE_STEPS
    launches = s1.launches - before
    s1_before, u1_before = s1.launches, u1.launches
    wall, kern = device_profile(
        lambda: sparse_embedding_step(mx, rng, hot, cluster, kv, out_buf),
        complete=lambda k: any("sparse_row_update_kernel" in n for n in k))
    s1_prof = s1.launches - s1_before
    u1_prof = u1.launches - u1_before
    busy = sum(v[1] for v in kern.values())
    in_trace = [v for n, v in kern.items() if "sparse_row_update_kernel" in n]
    wd = mx.nd.zeros((SPARSE_ROWS, SPARSE_DIM), ctx=mx.gpu(0))
    gd = mx.nd.ones((SPARSE_ROWS, SPARSE_DIM), ctx=mx.gpu(0))
    st = opt.create_state(1, wd)
    dense_ms = time_ms(lambda: opt.update(1, wd, gd, st), 10)
    summary = {"loss_first": losses[0], "loss_last10": float(np.mean(
        losses[-10:])), "step_ms": step_ms, "s1_launches": launches,
        "profiled_step": {"wall_ms": wall, "device_busy_ms": busy,
                          "s1_launches": s1_prof, "u1_launches": u1_prof,
                          "s1_in_trace": in_trace,
                          "kernels": len(kern)},
        "dense_full_table_update_device_ms": dense_ms}
    log("phase 23 sparse embedding loop %s" % json.dumps(summary))
    check(np.mean(losses[-10:]) < losses[0] * 0.7,
          "the loss went from %.4f to %.4f: the example wants below 0.7x"
          % (losses[0], np.mean(losses[-10:])))
    check(launches == SPARSE_STEPS, "S1 launched %d times in %d steps"
          % (launches, SPARSE_STEPS))
    check(s1_prof == 1 and u1_prof == 0 and in_trace and in_trace[0][0] == 1,
          "the profiled step launched S1 %d times (trace %s) and U1 %d "
          "times: want 1 and 0" % (s1_prof, in_trace, u1_prof))
    check(busy < dense_ms, "a sparse step kept the card busy %.4f ms, one "
          "dense full-table Adam update takes %.4f" % (busy, dense_ms))
    del kv, wd, gd, st, out_buf
    torch.cuda.empty_cache()
    return summary


def sparse_mlp(mx, ctx, params):
    net = mx.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(64, activation="relu", in_units=32),
                mx.gluon.nn.Dense(10, in_units=64))
    net.initialize(ctx=ctx)
    for name, p in net.collect_params().items():
        p.set_data(mx.nd.array(params[name], ctx=ctx))
    return net


def phase_sparse_card_vs_cpu(mx):
    """Phase 23c: gpu(0) against cpu() from the same inputs: 5 row-sparse
    pushes through a local kvstore with lazy Adam and with SGD momentum
    (weights and states, SPARSE_RTOL / SPARSE_ATOL); CSR dot at
    wide-deep's shapes and its taped backward (CSR_RTOL); one Trainer
    step and one Module step with a KVStore object (STEP_RTOL)."""
    from mxnet_tpu_torch.ndarray import sparse
    rng = np.random.RandomState(SEED + 233)
    cpu, gpu = mx.cpu(), mx.gpu(0)
    w0 = rng.randn(SPARSE_CHECK_ROWS, SPARSE_DIM).astype("f")
    pushes = []
    for _ in range(SPARSE_CHECK_PUSHES):
        rows = np.unique(rng.randint(0, SPARSE_CHECK_ROWS, 3 * SPARSE_BATCH))
        pushes.append((rows, (rng.randn(len(rows), SPARSE_DIM) * 2)
                       .astype("f")))
    out, fails = {}, []

    def close(name, got, want, rtol, atol):
        err = float(np.abs(got - want).max())
        out[name] = err
        if not np.allclose(got, want, rtol=rtol, atol=atol):
            fails.append("%s: max abs err %.3g" % (name, err))

    for name, kw in (("adam", {"learning_rate": 0.05}),
                     ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 1e-4})):
        res = {}
        for side, ctx in (("cpu", cpu), ("gpu", gpu)):
            kv = mx.kv.create("local")
            kv.init("emb", mx.nd.array(w0, ctx=ctx))
            kv.set_optimizer(mx.optimizer.create(name, **kw))
            for rows, vals in pushes:
                kv.push("emb", sparse.row_sparse_array(
                    (vals, rows), shape=w0.shape, ctx=ctx))
            st = kv._updater.states["emb"]
            st = st if isinstance(st, tuple) else (st,)
            res[side] = [kv._store["emb"].asnumpy()] + \
                [s.asnumpy() for s in st]
        for k, (a, b) in enumerate(zip(res["cpu"], res["gpu"])):
            close("%s_%s" % (name, ["weight", "state0", "state1"][k]), b, a,
                  SPARSE_RTOL, SPARSE_ATOL)
    cols = np.stack([rng.choice(CSR_SHAPE[1], CSR_PER_ROW, replace=False)
                     for _ in range(CSR_SHAPE[0])])
    dense = np.zeros(CSR_SHAPE, "f")
    dense[np.arange(CSR_SHAPE[0])[:, None], cols] = rng.rand(
        CSR_SHAPE[0], CSR_PER_ROW)
    rhs0 = rng.randn(CSR_SHAPE[1], CSR_COLS).astype("f")
    res = {}
    for side, ctx in (("cpu", cpu), ("gpu", gpu)):
        csr = sparse.csr_matrix(dense, ctx=ctx)
        rhs = mx.nd.array(rhs0, ctx=ctx)
        rhs.attach_grad()
        with mx.autograd.record():
            y = sparse.dot(csr, rhs)
            loss = (y * y).sum()
        loss.backward()
        res[side] = (y.asnumpy(), rhs.grad.asnumpy(),
                                csr._dense is None)
    close("csr_dot", res["gpu"][0], res["cpu"][0], CSR_RTOL, 1e-6)
    close("csr_dot_backward", res["gpu"][1], res["cpu"][1], CSR_RTOL, 1e-6)
    if not (res["gpu"][2] and res["cpu"][2]):
        fails.append("the CSR lhs was made dense")
    params = {"mlp_dense0_weight": rng.randn(64, 32).astype("f") * 0.2,
              "mlp_dense0_bias": np.zeros(64, "f"),
              "mlp_dense1_weight": rng.randn(10, 64).astype("f") * 0.2,
              "mlp_dense1_bias": np.zeros(10, "f")}
    x = rng.randn(16, 32).astype("f")
    y = rng.randint(0, 10, 16).astype("f")
    res = {}
    for side, ctx in (("cpu", cpu), ("gpu", gpu)):
        net = sparse_mlp(mx, ctx, params)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 0.01},
                                   kvstore=mx.kv.create("local"))
        with mx.autograd.record():
            loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                net(mx.nd.array(x, ctx=ctx)), mx.nd.array(y, ctx=ctx))
        loss.backward()
        trainer.step(16)
        res[side] = {n: p.data().asnumpy() for n, p in
                                net.collect_params().items()}
    for n in params:
        close("trainer_" + n, res["gpu"][n], res["cpu"][n], STEP_RTOL, 1e-6)
    sym = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(mx.sym.Activation(
        mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=64,
                              name="fc1"), act_type="relu"), num_hidden=10,
        name="fc2"), name="softmax")
    args = {"fc1_weight": params["mlp_dense0_weight"],
            "fc1_bias": params["mlp_dense0_bias"],
            "fc2_weight": params["mlp_dense1_weight"],
            "fc2_bias": params["mlp_dense1_bias"]}
    res = {}
    for side, ctx in (("cpu", cpu), ("gpu", gpu)):
        mod = mx.mod.Module(sym, context=ctx)
        mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                    for k, v in args.items()})
        mod.init_optimizer(kvstore=mx.kv.create("local"), optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.1),
                                             ("momentum", 0.9)))
        mod.forward(mx.io.DataBatch([mx.nd.array(x, ctx=ctx)],
                                    [mx.nd.array(y, ctx=ctx)]),
                    is_train=True)
        mod.backward()
        mod.update()
        res[side] = {k: v.asnumpy() for k, v in
                                mod.get_params()[0].items()}
    for n in args:
        close("module_" + n, res["gpu"][n], res["cpu"][n], STEP_RTOL, 1e-6)
    log("phase 23 card vs CPU %s" % json.dumps({"max_abs_err": out,
                                                "failed": fails}))
    check(not fails, "the sparse slice on the card against the CPU: "
          + "; ".join(fails))
    return out


def phase_sparse_examples(mx, counters):
    """Phase 23d: the sparse examples through ``tools/run_example`` on
    gpu(0): factorization_machine and wide_deep at their tests' arguments
    with ``--ctx tpu`` (their accuracy above the tests' limits, their
    Module's Adam on U1), sparse_embedding at
    ``--rows 100000 --steps 80`` (its OK line, one S1 launch a step), none
    of K1-K6 or N1; then sparse_embedding at its defaults, its outcome
    recorded whatever it is (its wall-clock assert times ``opt.update``
    without a synchronize)."""
    s1 = counters["sparse_row_update"]
    rows = {}
    for key, rel, argv, line, acc in SPARSE_EXAMPLES:
        before = {k: c.launches for k, c in counters.items()}
        run = run_example_captured(mx, rel, argv, "gpu")
        got = {k: c.launches - before[k] for k, c in counters.items()}
        hit = [ln for ln in run["lines"] if line in ln]
        row = {"line": hit[0] if hit else None, "seconds": run["seconds"],
               "devices": run["seen"], "launches": got}
        rows[key] = row
        log("phase 23 %s %s" % (key, json.dumps(row)))
        check(hit, "%s printed no %r line: %s" % (rel, line,
                                                  run["lines"][-5:]))
        if acc is not None:
            check(float(hit[0].split()[-1]) > acc, "%s: %s, want above %s"
                  % (key, hit[0], acc))
            check(got["multi_tensor_update"] > 0, "%s launched no U1: its "
                  "Module did not train on the card" % key)
        else:
            steps = int(argv[argv.index("--steps") + 1])
            check(got["sparse_row_update"] == steps,
                  "%s launched S1 %d times in %d steps"
                  % (key, got["sparse_row_update"], steps))
        check(not any(n for k, n in got.items() if k not in (
            "sparse_row_update", "multi_tensor_update")),
            "%s launched %s: want S1 and U1 only" % (key, got))
    from mxnet_tpu_torch.tools.run_example import run_example
    buf = io.StringIO()
    before = s1.launches
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            run_example("examples/sparse/sparse_embedding/train.py", [],
                        "gpu")
        outcome = "ok"
    except AssertionError as exc:
        outcome = "AssertionError: %s" % (exc,)
    lines = buf.getvalue().splitlines()
    timing = [ln for ln in lines if "dense full-table update" in ln]
    rows["sparse_embedding_defaults"] = {
        "outcome": outcome, "lines": lines[-3:], "timing": timing,
        "s1_launches": s1.launches - before,
        "seconds": time.perf_counter() - t0}
    log("phase 23 sparse_embedding defaults %s"
        % json.dumps(rows["sparse_embedding_defaults"]))
    return rows


# ---------------------------------------------------------------------------
# the RNN slice: mx.rnn, BucketSentenceIter, BucketingModule and gluon.rnn
# at the PTB LM's widths (phase 24)
# ---------------------------------------------------------------------------
def rnn_sentences(rng):
    """RNN_SENTENCES sentences of token ids, lengths RNN_LENGTHS."""
    lo, hi = RNN_LENGTHS
    return [list(rng.randint(1, VOCAB, n))
            for n in rng.randint(lo, hi + 1, RNN_SENTENCES)]


def bucket_lm_gen(mx, fused):
    """The bucketed word LM's ``sym_gen`` at the benchmark's widths: a
    ``FusedRNNCell`` stack (``fused``), or the unrolled ``LSTMCell``
    stack of `examples/rnn/word_lm/train.py:67-85`."""
    if fused:
        cell = mx.rnn.FusedRNNCell(HIDDEN, num_layers=LAYERS, mode="lstm",
                                   prefix="lstm_")
    else:
        cell = mx.rnn.SequentialRNNCell()
        for i in range(LAYERS):
            cell.add(mx.rnn.LSTMCell(num_hidden=HIDDEN,
                                     prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=VOCAB, output_dim=EMBED,
                                 name="embed")
        cell.reset()
        out, _ = cell.unroll(seq_len, inputs=embed, layout="NTC",
                             merge_outputs=True)
        pred = mx.sym.FullyConnected(mx.sym.Reshape(out, shape=(-1, HIDDEN)),
                                     num_hidden=VOCAB, name="pred")
        pred = mx.sym.SoftmaxOutput(
            pred, mx.sym.Reshape(label, shape=(-1,)), name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def bucketing_module(mx, ctx, fused, key, arg_params=None):
    """A bound BucketingModule with SGD (lr 1, clip 0.25), from
    ``arg_params`` or seeded Xavier."""
    mod = mx.mod.BucketingModule(bucket_lm_gen(mx, fused),
                                 default_bucket_key=key, context=ctx)
    mod.bind(data_shapes=[("data", (TRAIN_BATCH, key))],
             label_shapes=[("softmax_label", (TRAIN_BATCH, key))])
    mx.random.seed(SEED)
    mod.init_params(initializer=mx.init.Xavier(), arg_params=arg_params)
    mod.init_optimizer(optimizer="sgd", optimizer_params=TRAIN_OPT)
    return mod


def launches_of(counters):
    return {k: c.launches for k, c in counters.items()}


def launched(counters, before):
    return {k: c.launches - before[k] for k, c in counters.items()}


def bucket_tokens(it):
    """Tokens of one epoch of ``it``."""
    return sum(TRAIN_BATCH * it.buckets[i] for i, _ in it.idx)


def phase_rnn_lm(mx, counters, rng):
    """Phase 24a: the bucketed 2x650 LM through ``BucketingModule.fit``
    on gpu(0), one epoch of a ``BucketSentenceIter`` (buckets RNN_BUCKETS,
    batch 32), then one more epoch timed step by step and ``score``: K2
    and K3 once a layer and step, U1 once a step, K1 once a layer and
    eval batch; the buckets' executors share the parameter arrays. Then
    the example's unrolled LSTMCell stack, UNROLLED_STEPS timed steps:
    none of K1-K3. Returns (the module, the iterator, the summary)."""
    it = mx.rnn.BucketSentenceIter(rnn_sentences(rng), TRAIN_BATCH,
                                   buckets=list(RNN_BUCKETS),
                                   invalid_label=0)
    steps, tokens = len(it.idx), bucket_tokens(it)
    mod = mx.mod.BucketingModule(bucket_lm_gen(mx, True),
                                 default_bucket_key=it.default_bucket_key,
                                 context=mx.gpu(0))
    before = launches_of(counters)
    mx.random.seed(SEED)
    train_ppl = mx.metric.Perplexity()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=TRAIN_OPT,
            eval_metric=train_ppl, initializer=mx.init.Xavier())
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    fit = launched(counters, before)
    it.reset()
    before = launches_of(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in it:
        mod.forward_backward(batch)
        mod.update()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    epoch2 = launched(counters, before)
    before = launches_of(counters)
    compiles = mx.compiled.compile_counts()["compiles"]
    (_, eval_ppl), = mod.score(it, mx.metric.Perplexity())
    score = launched(counters, before)
    score_compiles = mx.compiled.compile_counts()["compiles"] - compiles
    default = mod._buckets[it.default_bucket_key]
    shared = all(m._exec.arg_dict[n] is default._exec.arg_dict[n]
                 and m._exec.grad_dict[n] is default._exec.grad_dict[n]
                 for m in mod._buckets.values() for n in m._param_names)
    summary = {
        "buckets": list(RNN_BUCKETS), "batches_an_epoch": steps,
        "tokens_an_epoch": tokens, "fit_wall_s": fit_wall,
        "fit_tokens_per_s": tokens / fit_wall,
        "tokens_per_s": tokens / wall, "steady_epoch_wall_s": wall,
        "fit_train_perplexity": train_ppl.get()[1],
        "eval_perplexity": eval_ppl, "launches_fit": fit,
        "launches_second_epoch": epoch2, "launches_score": score,
        "score_compiles": score_compiles,
        "bucket_modules": sorted(mod._buckets), "arrays_shared": shared,
        "updater_shared": all(m._updater is default._updater
                              for m in mod._buckets.values())}
    log("phase 24a bucketed LM %s" % json.dumps(summary))
    for what, got in (("fit", fit), ("the second epoch", epoch2)):
        check(got["fused_lstm_train"] == LAYERS * steps
              and got["lstm_bwd_recurrence"] == LAYERS * steps,
              "%s launched K2 %d and K3 %d times in %d steps, want %d each"
              % (what, got["fused_lstm_train"], got["lstm_bwd_recurrence"],
                 steps, LAYERS * steps))
        check(got["multi_tensor_update"] == steps,
              "%s launched U1 %d times in %d steps, want one a step"
              % (what, got["multi_tensor_update"], steps))
    # a replay a batch, and the warm-up runs of each bucket's capture
    want = LAYERS * (steps + mx.compiled.WARMUP_RUNS * score_compiles)
    check(1 <= score_compiles <= len(RNN_BUCKETS)
          and score["fused_lstm"] == want,
          "score compiled %d signatures and launched K1 %d times over %d "
          "batches, want one a bucket and %d"
          % (score_compiles, score["fused_lstm"], steps, want))
    check(shared and summary["updater_shared"]
          and summary["bucket_modules"] == sorted(RNN_BUCKETS),
          "the buckets %s do not share one set of arrays and one updater"
          % summary["bucket_modules"])
    check(np.isfinite(eval_ppl), "eval perplexity %s" % eval_ppl)

    unrolled = bucketing_module(mx, mx.gpu(0), False, max(RNN_BUCKETS))
    it.reset()
    batches = [b for b, _ in zip(it, range(UNROLLED_STEPS + 1))]
    unrolled.forward_backward(batches[0])       # binds its bucket
    unrolled.update()
    before = launches_of(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[1:]:
        unrolled.forward_backward(batch)
        unrolled.update()
    torch.cuda.synchronize()
    u_wall = time.perf_counter() - t0
    got = launched(counters, before)
    row = {"steps": UNROLLED_STEPS,
           "tokens_per_s": sum(TRAIN_BATCH * b.bucket_key
                               for b in batches[1:]) / u_wall,
           "launches": got}
    log("phase 24a unrolled LSTMCell stack %s" % json.dumps(row))
    check(got["fused_lstm"] == got["fused_lstm_train"]
          == got["lstm_bwd_recurrence"] == 0,
          "the unrolled LSTMCells launched %s: they build elementwise "
          "symbols, no fused RNN op" % got)
    check(got["multi_tensor_update"] == UNROLLED_STEPS,
          "the unrolled stack launched U1 %d times in %d steps"
          % (got["multi_tensor_update"], UNROLLED_STEPS))
    summary["unrolled"] = row
    del unrolled
    return mod, it, summary


def rnn_f64_steps(mx, params, batches):
    """``batches`` in order, one SGD step each (lr 1, clip 0.25), on
    cpu() in f64 from ``params``: a Module a bucket, as SGD without
    momentum carries no state from one step to the next. Returns the
    parameters."""
    gen = bucket_lm_gen(mx, True)
    for batch in batches:
        k = batch.bucket_key
        sym, _, _ = gen(k)
        mod = mx.mod.Module(sym, context=mx.cpu())
        mod.bind(data_shapes=[("data", (TRAIN_BATCH, k))],
                 label_shapes=[("softmax_label", (TRAIN_BATCH, k))],
                 type_dict={n: np.float64 for n in sym.list_arguments()})
        mod.init_params(arg_params={
            n: mx.nd.array(v, ctx=mx.cpu(), dtype=np.float64)
            for n, v in params.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params=TRAIN_OPT)
        mod.forward_backward(mx.io.DataBatch(
            [batch.data[0].astype(np.float64)],
            [batch.label[0].astype(np.float64)]))
        mod.update()
        params = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
    return params


@contextlib.contextmanager
def plain_rnn_kernels():
    """While the block runs, K2, K3 and U1 are their plain versions, on
    whatever device the tensors lie: the bucketed path on the card with no
    hand kernel, which launches none and counts none."""
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.ops import lstm_kernel, multi_tensor
    saved = (lstm_kernel.fused_lstm_train, lstm_kernel.lstm_bwd_recurrence,
             optimizer.multi_tensor_update)

    def plain_u1(*args, buffers=None, **kw):
        multi_tensor.multi_tensor_update_plain(*args, **kw)
    lstm_kernel.fused_lstm_train = lstm_kernel.fused_lstm_train_plain
    lstm_kernel.lstm_bwd_recurrence = lstm_kernel.lstm_bwd_recurrence_plain
    optimizer.multi_tensor_update = plain_u1
    try:
        yield
    finally:
        (lstm_kernel.fused_lstm_train, lstm_kernel.lstm_bwd_recurrence,
         optimizer.multi_tensor_update) = saved


def bucket_steps(mx, ctx, weights, batches):
    """The bucketed LM on ``ctx`` from ``weights``, one step each over
    ``batches``: its parameters after them."""
    mod = bucketing_module(mx, ctx, True, max(RNN_BUCKETS), weights)
    for batch in batches:
        mod.forward_backward(batch)
        mod.update()
    return {n: a.asnumpy() for n, a in mod.get_params()[0].items()}


def trained_witness(mx, counters, trained, batches):
    """From ``trained``, the same steps over ``batches`` on gpu(0) and on
    cpu() in f32 (``bucket_pair_steps``), on gpu(0) with K2, K3 and U1 in
    their plain versions, and on cpu() in f64; and the control, the card
    with the last step dropped. Returns (the steps' rows, each parameter's
    readings: card vs CPU, each run's relative distance to the f64 run,
    whether the card's values are finite)."""
    rows, card, host = bucket_pair_steps(mx, trained, batches,
                                         "from 24a's weights")
    got = {n: a.asnumpy() for n, a in card.get_params()[0].items()}
    want = {n: a.asnumpy() for n, a in host.get_params()[0].items()}
    del card, host
    dropped = bucket_steps(mx, mx.gpu(0), trained, batches[:-1])
    before = launches_of(counters)
    with plain_rnn_kernels():
        plain = bucket_steps(mx, mx.gpu(0), trained, batches)
    plain_launches = launched(counters, before)
    check(not any(plain_launches.values()),
          "the plain witness run launched %s" % plain_launches)
    exact = rnn_f64_steps(mx, trained, batches)
    witness = {}
    for name in got:
        witness[name] = {
            "card_vs_cpu_max_abs": float(np.abs(got[name] - want[name]).max()),
            "within_phase8_limits": bool(np.allclose(
                got[name], want[name], rtol=PARAM_RTOL, atol=PARAM_ATOL)),
            **{key + "_vs_f64_rel": rel_err(run[name].astype(np.float64),
                                            exact[name])
               for key, run in (("card", got), ("plain_card", plain),
                                ("cpu", want), ("control", dropped))},
            "cpu_within_phase8_limits_of_f64": bool(np.allclose(
                want[name], exact[name], rtol=PARAM_RTOL, atol=PARAM_ATOL)),
            "card_finite": bool(np.isfinite(got[name]).all())}
    return rows, witness


def bucket_pair_steps(mx, weights, batches, what):
    """The bucketed LM on gpu(0) and on cpu() from ``weights`` (None:
    the seed's), one step
    each over ``batches``: the step outputs' largest difference, and the
    two modules."""
    key = max(RNN_BUCKETS)
    card = bucketing_module(mx, mx.gpu(0), True, key, weights)
    if weights is None:                 # the seed's
        weights = {n: a.asnumpy() for n, a in card.get_params()[0].items()}
    host = bucketing_module(mx, mx.cpu(), True, key, weights)
    rows = []
    for batch in batches:
        for m in (card, host):
            m.forward_backward(batch)
            m.update()
        got, want = (m.get_outputs()[0].asnumpy() for m in (card, host))
        rows.append({"bucket": batch.bucket_key, "output_max_abs_err":
                     float(np.abs(got - want).max()),
                     "outputs_close": bool(np.allclose(
                         got, want, rtol=TRAIN_RTOL, atol=TRAIN_ATOL))})
        log("phase 24b %s, step over bucket %d: output max abs err %.3g"
            % (what, batch.bucket_key, rows[-1]["output_max_abs_err"]))
        check(got.shape == (TRAIN_BATCH * batch.bucket_key, VOCAB)
              and bool(np.isfinite(got).all()),
              "the bucket-%d step's outputs: %s" % (batch.bucket_key,
                                                   got.shape))
    return rows, card, host


def phase_rnn_card_vs_cpu(mx, counters, it, trained):
    """Phase 24b: 2 steps over two buckets (the two shortest) on gpu(0)
    and on cpu() from the same weights, twice. From the seed (phase 8's
    starting point): outputs at TRAIN_RTOL/ATOL and parameters at
    PARAM_RTOL/ATOL, phase 8's limits. From 24a's ``trained`` weights,
    where no f32 run holds those limits against f64: each f32 run's
    distance to the same steps in f64 (the card, the card with plain K2,
    K3 and U1, the CPU), printed, and each parameter of the card
    RNN_CONTROL times nearer the f64 run than the card with its last step
    dropped."""
    key = max(RNN_BUCKETS)
    it.reset()
    picked = {}
    for batch in it:
        if batch.bucket_key in RNN_BUCKETS[:2]:
            picked.setdefault(batch.bucket_key, batch)
        if len(picked) == 2:
            break
    batches = [picked[k] for k in sorted(picked)]
    rows, card, host = bucket_pair_steps(mx, None, batches, "from the seed")
    errs = {}
    for name, arr in card.get_params()[0].items():
        got, want = arr.asnumpy(), host.get_params()[0][name].asnumpy()
        errs[name] = (float(np.abs(got - want).max()),
                      bool(np.allclose(got, want, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL)))
    default = card._buckets[key]
    shared = all(card._buckets[k]._exec.arg_dict[n] is
                 default._exec.arg_dict[n] for k in picked
                 for n in default._param_names)
    summary = {"steps": rows, "param_max_abs_err":
               {n: e for n, (e, _) in errs.items()},
               "bucket_arrays_are_the_default_buckets": shared}
    log("phase 24b card vs cpu from the seed %s" % json.dumps(summary))
    check(all(r["outputs_close"] for r in rows),
          "the bucketed steps' outputs differ from the CPU's: %s" % rows)
    check(all(ok for _, ok in errs.values()),
          "parameters after 2 bucketed steps differ from the CPU's: %s"
          % [n for n, (_, ok) in errs.items() if not ok])
    check(shared, "a bucket's executor holds copies of the parameters")
    del card, host

    rows, witness = trained_witness(mx, counters, trained, batches)
    summary["trained"] = {"steps": rows, "params": witness,
                          "control_limit": RNN_CONTROL}
    log("phase 24b card vs cpu from 24a's weights, f64 witness %s"
        % json.dumps(summary["trained"]))
    check(all(w["card_finite"] for w in witness.values()),
          "the card's parameters from 24a's weights are not finite")
    check(all(w["control_vs_f64_rel"] > RNN_CONTROL * w["card_vs_f64_rel"]
              for w in witness.values()),
          "from 24a's weights the card lies less than %g times nearer the "
          "f64 run than the card with its last step dropped: %s"
          % (RNN_CONTROL, witness))
    return summary


def gluon_lm(mx, ctx, prefix="glm_"):
    """Embedding(10000, 650) -> gluon.rnn.LSTM(650, 2 layers, TNC) ->
    Dense(10000, flatten=False), deferred shapes finished, hybridized."""
    net = mx.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(mx.gluon.nn.Embedding(VOCAB, EMBED),
                mx.gluon.rnn.LSTM(HIDDEN, num_layers=LAYERS),
                mx.gluon.nn.Dense(VOCAB, flatten=False))
    mx.random.seed(SEED)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with mx.autograd.pause():
        net(mx.nd.zeros((SEQ, TRAIN_BATCH), ctx=ctx))
    net.hybridize()
    return net


def gluon_lm_step(mx, net, trainer, loss_fn, x, y):
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(TRAIN_BATCH)
    return loss


def phase_gluon_lstm(mx, counters, rng):
    """Phase 24c: the Gluon LSTM LM at full width. 2 recorded SGD steps
    (lr 1, clip 0.25) on gpu(0) and cpu() from the card's weights: every
    gradient and update by relative norm to LSTM_GRAD_REL, with two
    controls that must fail it (the card's h2h gradients with K3's dWh
    product zeroed; the card's second update against the CPU's first).
    Then GLUON_LM_WARMUP + GLUON_LM_STEPS steps (tokens/s, K2 and K3 once
    a layer and step, U1 once a step) and a profiled one; then the
    hybridized call outside ``record()``: one captured CUDA graph holding
    K1's cooperative launches, its logits against the eager call and the
    CPU's by relative norm to INFER_REL, its replays one
    ``cudaGraphLaunch`` each with K1's kernels inside, which K1's
    counter adds at each replay (ops/launch_count.py): the counter
    against the profiler's count of the kernels in a replay."""
    from mxnet_tpu_torch.ops import lstm_kernel
    card = gluon_lm(mx, mx.gpu(0))
    host = gluon_lm(mx, mx.cpu())
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainers = [mx.gluon.Trainer(n.collect_params(), "sgd", dict(TRAIN_OPT))
                for n in (card, host)]
    data = [(rng.randint(0, VOCAB, (SEQ, TRAIN_BATCH)).astype(np.float32),
             rng.randint(0, VOCAB, (SEQ, TRAIN_BATCH)).astype(np.float32))
            for _ in range(2 + GLUON_LM_WARMUP + GLUON_LM_STEPS)]

    def values(net):
        return {n: p.data().asnumpy() for n, p in
                net.collect_params().items()}

    def grads(net):
        return {n: p.grad().asnumpy() for n, p in
                net.collect_params().items()}

    def backward(net, ctx, x, y):
        with mx.autograd.record():
            loss = loss_fn(net(mx.nd.array(x, ctx=ctx)),
                           mx.nd.array(y, ctx=ctx))
        loss.backward()
        return loss

    before_all = launches_of(counters)
    rows, controls, moved_prev = [], {}, None
    for step, (x, y) in enumerate(data[:2]):
        mx.set_block_params(host, values(card))
        start = values(card)
        backward(host, mx.cpu(), x, y)
        want = grads(host)
        if step == 0:
            saved = lstm_kernel._backward_products

            def no_dwh(*args):
                dx, dwx, dwh, db = saved(*args)
                return dx, dwx, torch.zeros_like(dwh), db
            lstm_kernel._backward_products = no_dwh
            try:
                backward(card, mx.gpu(0), x, y)
            finally:
                lstm_kernel._backward_products = saved
            cut = grads(card)
            controls["dwh_zeroed"] = max(
                rel_err(cut[n], want[n]) for n in want if "h2h_weight" in n)
        backward(card, mx.gpu(0), x, y)
        got = grads(card)
        for t in trainers:
            t.step(TRAIN_BATCH)
        moved = {n: v - start[n] for n, v in values(card).items()}
        moved_ref = {n: v - start[n] for n, v in values(host).items()}
        if moved_prev is not None:
            controls["second_update_vs_first"] = max(
                rel_err(moved[n], moved_prev[n]) for n in moved)
        moved_prev = moved_ref
        rows.append({"grad_rel": leaf_errs(got, want),
                     "update_rel": leaf_errs(moved, moved_ref)})
        log("phase 24c step %d vs cpu %s" % (step, json.dumps(rows[-1])))
    log("phase 24c controls %s (limit %g)" % (json.dumps(controls),
                                               LSTM_GRAD_REL))
    check(all(r[k]["max"] < LSTM_GRAD_REL for r in rows
              for k in ("grad_rel", "update_rel")),
          "the Gluon LSTM's gradients or updates differ from the CPU's "
          "beyond %g" % LSTM_GRAD_REL)
    check(all(v > LSTM_GRAD_REL for v in controls.values())
          and len(controls) == 2,
          "a control passed the limit %g: %s" % (LSTM_GRAD_REL, controls))
    del host
    torch.cuda.empty_cache()

    batches = [(mx.nd.array(x, ctx=mx.gpu(0)), mx.nd.array(y, ctx=mx.gpu(0)))
               for x, y in data[2:]]
    losses = [float(gluon_lm_step(mx, card, trainers[0], loss_fn,
                                  *b).mean().asscalar())
              for b in batches[:GLUON_LM_WARMUP]]
    before = launches_of(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[GLUON_LM_WARMUP:]:
        loss = gluon_lm_step(mx, card, trainers[0], loss_fn, *b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timed = launched(counters, before)
    losses.append(float(loss.mean().asscalar()))
    train = {"steps": GLUON_LM_STEPS,
             "tokens_per_s": GLUON_LM_STEPS * SEQ * TRAIN_BATCH / wall,
             "step_ms": wall * 1e3 / GLUON_LM_STEPS, "losses": losses,
             "launches": timed}
    log("phase 24c gluon LSTM training %s" % json.dumps(train))
    check(timed["fused_lstm_train"] == LAYERS * GLUON_LM_STEPS
          and timed["lstm_bwd_recurrence"] == LAYERS * GLUON_LM_STEPS,
          "the Gluon LSTM launched K2 %d and K3 %d times in %d steps"
          % (timed["fused_lstm_train"], timed["lstm_bwd_recurrence"],
             GLUON_LM_STEPS))
    check(timed["multi_tensor_update"] == GLUON_LM_STEPS,
          "the Gluon LSTM's Trainer launched U1 %d times in %d steps"
          % (timed["multi_tensor_update"], GLUON_LM_STEPS))
    check(all(np.isfinite(losses)), "losses %s" % losses)

    x = batches[0][0]
    with mx.compiled.inline("chip_smoke.eager"):
        eager = card(x).data.clone()
    mx.compiled.reset()
    k1 = counters["fused_lstm"]
    before_k1 = k1.launches
    first = card(x).data.clone()        # warm-up runs, the capture, a replay
    k1_first = k1.launches - before_k1
    counts = mx.compiled.compile_counts()
    before_k1 = k1.launches
    second = card(x).data.clone()         # a replay
    k1_replay = k1.launches - before_k1
    (entry,) = [e for e in card._cached_jit._cache.values()
                if type(e).__name__ == "_Graph"] or [None]
    recorded = None if entry is None else [
        "fused_lstm" if w is k1 else w.__name__ for w, _ in entry.launches]
    host = gluon_lm(mx, mx.cpu(), prefix=card.prefix)
    mx.set_block_params(host, values(card))
    want = host(mx.nd.array(x.asnumpy(), ctx=mx.cpu())).asnumpy()
    # the profiles: a training step and a replay, in a fresh process
    prof = lstm_profile()
    train.update(prof["train"])
    log("phase 24c gluon LSTM training profile %s" % json.dumps(
        prof["train"]))
    replay = prof["replay"]
    counted = [prof["k1_counted_profiled_replay"]]
    k1_in_graph = prof["k1_kernels_in_a_replay"]
    infer = {"compile_counts": counts,
             "captured": entry is not None,
             "launches_recorded_at_capture": recorded,
             "k1_counted_first_call": k1_first,
             "k1_counted_a_replay": k1_replay,
             "k1_counted_profiled_replay": counted[-1],
             "rel_vs_eager": rel_err(first.cpu().numpy(),
                                     eager.cpu().numpy()),
             "rel_vs_cpu": rel_err(first.cpu().numpy(), want),
             "replay_bit_identical": bool(torch.equal(first, second)),
             "replay_runtime_calls": replay["runtime_calls"],
             "replay_wall_ms": replay["wall_ms"],
             "replay_device_busy_ms": replay["device_busy_ms"],
             "k1_kernels_in_a_replay": k1_in_graph}
    log("phase 24c hybridized inference %s" % json.dumps(infer))
    check(entry is not None and counts["uncaptured"] == 0
          and counts["compiles"] == 1,
          "the hybridized LSTM was not captured: %s" % counts)
    check(infer["rel_vs_eager"] < INFER_REL and infer["rel_vs_cpu"]
          < INFER_REL, "the captured logits read %.3g against the eager "
          "call and %.3g against the CPU (limit %g)"
          % (infer["rel_vs_eager"], infer["rel_vs_cpu"], INFER_REL))
    check(recorded == ["fused_lstm"] * LAYERS
          and k1_first == LAYERS * (mx.compiled.WARMUP_RUNS + 1)
          and k1_replay == LAYERS,
          "the capture recorded %s; K1's counter moved %d at the first "
          "call (warm-ups and a replay) and %d at a replay"
          % (recorded, k1_first, k1_replay))
    check(replay["runtime_calls"].get("cudaGraphLaunch") == 1
          and sum(k1_in_graph.values()) == LAYERS == counted[-1],
          "a replay made %s runtime calls with K1 kernels %s and K1's "
          "counter moved %d, want one cudaGraphLaunch holding %d"
          % (replay["runtime_calls"], k1_in_graph, counted[-1], LAYERS))
    summary = {"vs_cpu": rows, "controls": controls, "limit": LSTM_GRAD_REL,
               "train": train, "inference": infer,
               "launches": launched(counters, before_all)}
    del card, host
    torch.cuda.empty_cache()
    return summary


LSTM_PROFILE_TIMEOUT_S = 300


def lstm_profile():
    """Phase 24c's profiles, run by ``chip_smoke.py --lstm-profile`` in a
    process of its own (``lstm_profile_main``); returns its JSON line.
    Late in this script's process six traces of a graph replay held no K1
    kernel, though the counter and the ``cudaGraphLaunch`` saw it; the
    later phases' profiles already run in fresh processes."""
    return run_own_process("--lstm-profile", LSTM_PROFILE_TIMEOUT_S)


def lstm_profile_main():
    """The Gluon LSTM LM of phase 24c on gpu(0) (TF32 off): two recorded
    SGD steps, then one profiled (wall and busy ms, the idle share, K2's
    and K3's kernels); then the hybridized call outside ``record()``,
    captured, with one replay's runtime calls (``call_profile``) and one
    replay's device kernels, K1's counter read around it. Prints one JSON
    line."""
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(SEED + 24)
    card = gluon_lm(mx, mx.gpu(0))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(card.collect_params(), "sgd", dict(TRAIN_OPT))
    batches = [(mx.nd.array(rng.randint(0, VOCAB, (SEQ, TRAIN_BATCH)),
                            ctx=mx.gpu(0), dtype=np.float32),
                mx.nd.array(rng.randint(0, VOCAB, (SEQ, TRAIN_BATCH)),
                            ctx=mx.gpu(0), dtype=np.float32))
               for _ in range(2)]
    for b in batches:
        gluon_lm_step(mx, card, trainer, loss_fn, *b)
    prof_wall, kern = device_profile(
        lambda: gluon_lm_step(mx, card, trainer, loss_fn, *batches[-1]))
    busy = sum(ms for _, ms in kern.values())
    train = {"profiled_step_wall_ms": prof_wall, "device_busy_ms": busy,
             "device_idle_share": (1 - busy / prof_wall) if kern else None,
             "k2": kernel_share(kern, K2_KERNELS, busy),
             "k3": kernel_share(kern, K3_KERNELS, busy)}
    x = batches[0][0]
    card(x)                      # warm-up runs, the capture, a replay
    card(x)
    k1 = mx.ops.fused_lstm
    replay = call_profile(lambda: card(x))
    counted = []

    def profiled_replay():
        n = k1.launches
        card(x)
        counted.append(k1.launches - n)
    _, replay_kern = device_profile(
        profiled_replay, complete=lambda k: any(f in n for n in k
                                                for f in K1_KERNELS))
    print(json.dumps({
        "train": train, "replay": replay,
        "k1_counted_profiled_replay": counted[-1],
        "k1_kernels_in_a_replay": kernel_share(replay_kern, K1_KERNELS,
                                               1.0)["launches"]}),
        flush=True)
    return 0


def phase_rnn_modes(mx, counters, device):
    """Phase 24d: K1, K2 and K3 against their plain versions at
    bi-lstm-sort's shape, both directions, each call's route recorded;
    ``gru`` and ``rnn_tanh`` (2 layers, bidirectional, the LM's widths)
    forward and backward on the card against the CPU, by the largest
    difference over the largest magnitude, to RNN_MODE_REL; and the RNN
    op's inter-layer dropout (p = 0.5, 2 LSTM layers) on the card: the
    same seed the same output, another seed another, the output equal
    to the layers run one by one with the first one's output masked by
    the same draw and scaled by 1/(1-p), the keep rate within 4 sigma."""
    from mxnet_tpu_torch.ops import lstm_kernel as lk
    from mxnet_tpu_torch.ops.registry import get_op
    ops = mx.ops
    t, b, i, h = RNN_SORT_SHAPE
    x, h0, c0, wx, wh, bias = lstm_inputs(t, b, i, h, device, SEED + 24)
    cots = cotangents(t, b, h, device, SEED + 25)
    rows = []
    for direction in ("forward", "reverse"):
        xs = torch.flip(x, (0,)) if direction == "reverse" else x
        routes = {k: dict(c.launches_by_route) for k, c in (
            ("k1", ops.fused_lstm), ("k2", ops.fused_lstm_train),
            ("k3", ops.lstm_bwd_recurrence))}
        _, cseq, gates = lk.fused_lstm_train_plain(xs, h0, c0, wx, wh, bias)
        pairs = {"k1": (ops.fused_lstm(xs, h0, c0, wx, wh, bias),
                        lk.fused_lstm_plain(xs, h0, c0, wx, wh, bias)),
                 "k2": (ops.fused_lstm_train(xs, h0, c0, wx, wh, bias),
                        lk.fused_lstm_train_plain(xs, h0, c0, wx, wh, bias)),
                 "k3": (ops.lstm_bwd_recurrence(*cots, gates, cseq, c0, wh),
                        lk.lstm_bwd_recurrence_plain(*cots, gates, cseq, c0,
                                                     wh))}
        torch.cuda.synchronize()
        errs = {k: max(float((g - w).abs().max()) for g, w in zip(*pair))
                for k, pair in pairs.items()}
        close = {k: all(bool(torch.isfinite(g).all())
                         and bool(torch.allclose(g, w, rtol=LSTM_ATOL,
                                                 atol=LSTM_ATOL))
                         for g, w in zip(*pair))
                 for k, pair in pairs.items()}
        took = {k: {r: n - routes[k][r] for r, n in c.launches_by_route.items()
                    if n - routes[k][r]}
                for k, c in (("k1", ops.fused_lstm),
                             ("k2", ops.fused_lstm_train),
                             ("k3", ops.lstm_bwd_recurrence))}
        rows.append({"direction": direction, "shape": RNN_SORT_SHAPE,
                     "max_abs_err": errs, "routes": took})
        log("phase 24d bi-lstm-sort shape %s" % json.dumps(rows[-1]))
        check(all(close.values()), "K1-K3 at bi-lstm-sort's shape (%s) "
              "differ from their plain versions: %s" % (direction, errs))

    op = get_op("RNN")
    modes = {}
    for mode in ("gru", "rnn_tanh"):
        gen = np.random.RandomState(SEED + 26)
        n = mx.ops.nn.rnn_param_size(LAYERS, EMBED, HIDDEN, True, mode)
        host = [torch.from_numpy(a.astype(np.float32)) for a in (
            gen.randn(SEQ, TRAIN_BATCH, EMBED), gen.randn(n) * 0.05,
            gen.randn(2 * LAYERS, TRAIN_BATCH, HIDDEN) * 0.5)]
        cot = [torch.from_numpy(gen.randn(SEQ, TRAIN_BATCH, 2 * HIDDEN)
                                .astype(np.float32)),
               torch.from_numpy(gen.randn(2 * LAYERS, TRAIN_BATCH, HIDDEN)
                                .astype(np.float32))]
        params = {"mode": mode, "state_size": HIDDEN, "num_layers": LAYERS,
                  "bidirectional": True, "state_outputs": True,
                  "_is_train": True, "_generator": None}
        res = {}
        for dev in ("cpu", device):
            ins = [a.detach().to(dev).requires_grad_(True) for a in host]
            outs = op.fcompute(dict(params), *ins)
            torch.autograd.backward(outs, [c.to(dev) for c in cot])
            res[str(dev)] = [o.detach().cpu().numpy() for o in outs] + \
                [a.grad.cpu().numpy() for a in ins]
        names = ["output", "h_n", "d_data", "d_parameters", "d_state"]
        errs = {nm: float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
                for nm, g, w in zip(names, res[str(device)], res["cpu"])}
        modes[mode] = errs
        log("phase 24d %s card vs cpu %s (limit %g)"
            % (mode, json.dumps(errs), RNN_MODE_REL))
    check(all(e < RNN_MODE_REL for m in modes.values() for e in m.values()),
          "gru / rnn_tanh on the card differ from the CPU: %s" % modes)

    base = {"mode": "lstm", "state_size": HIDDEN, "num_layers": LAYERS,
            "p": RNN_DROPOUT, "_is_train": True, "_ctx": mx.gpu(0)}
    gen = np.random.RandomState(SEED + 27)
    layer = [[torch.from_numpy((gen.randn(*s) * 0.05).astype(np.float32))
              .to(device) for s in ((4 * HIDDEN, EMBED),
                                    (4 * HIDDEN, HIDDEN), (4 * HIDDEN,),
                                    (4 * HIDDEN,))] for _ in range(LAYERS)]
    flat = torch.cat([w.reshape(-1) for lw in layer for w in lw[:2]]
                     + [w for lw in layer for w in lw[2:]])
    xd = torch.from_numpy(gen.randn(SEQ, TRAIN_BATCH, EMBED)
                          .astype(np.float32)).to(device)
    z = torch.zeros(LAYERS, 1, HIDDEN, device=device)

    def run(seed):
        g = torch.Generator(device=device).manual_seed(seed)
        return op.fcompute(dict(base, _generator=g), xd, flat, z, z)[0]

    def one(data, lw):
        w = torch.cat([lw[0].reshape(-1), lw[1].reshape(-1), lw[2], lw[3]])
        return op.fcompute(dict(base, num_layers=1), data, w, z[:1],
                           z[:1])[0]
    with torch.no_grad():
        a, a2, c = run(7), run(7), run(8)
        y1 = one(xd, layer[0])
        mask = torch.bernoulli(torch.full_like(y1, 1 - RNN_DROPOUT),
                               generator=torch.Generator(device=device)
                               .manual_seed(7))
        want = one(y1 * mask / (1 - RNN_DROPOUT), layer[1])
    keep = float(mask.mean())
    sigma = float(np.sqrt(RNN_DROPOUT * (1 - RNN_DROPOUT) / mask.numel()))
    drop = {"elements": mask.numel(), "keep_rate": keep,
            "keep_sigmas": abs(keep - (1 - RNN_DROPOUT)) / sigma,
            "same_seed_same": bool(torch.equal(a, a2)),
            "other_seed_differs": not bool(torch.equal(a, c)),
            "equals_scaled_layers": bool(torch.equal(a, want)),
            "max_abs_vs_scaled_layers": float((a - want).abs().max())}
    log("phase 24d RNN dropout %s" % json.dumps(drop))
    check(drop["keep_sigmas"] < 4 and drop["same_seed_same"]
          and drop["other_seed_differs"] and drop["equals_scaled_layers"],
          "the RNN op's dropout on the card: %s" % drop)
    return {"bi_lstm_sort_shape": rows, "modes_vs_cpu": modes,
            "dropout": drop}


def phase_rnn_examples(mx, counters):
    """Phase 24e: the four RNN examples through ``tools/run_example`` on
    gpu(0), each printing its JAX test's line, with K1-K3 and U1
    launches and its own clock line where it prints one."""
    from mxnet_tpu_torch.tools.run_example import run_example
    rows = {}
    root = logging.getLogger()
    for key, rel, argv, line, want in RNN_EXAMPLES:
        before = launches_of(counters)
        buf = io.StringIO()
        handler, level = logging.StreamHandler(buf), root.level
        root.addHandler(handler)           # word_lm's clock lines log
        root.setLevel(logging.INFO)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                run_example(os.path.join("examples", rel), argv, "gpu")
        finally:
            root.removeHandler(handler)
            root.setLevel(level)
        lines = buf.getvalue().splitlines()
        got = launched(counters, before)
        hit = [ln for ln in lines if line in ln]
        clock = [ln for ln in lines if "tokens/s" in ln or "Time cost" in ln
                 or "samples/sec" in ln]
        rows[key] = {"line": hit[0] if hit else None, "clock": clock[-2:],
                     "launches": got, "seconds": time.perf_counter() - t0}
        log("phase 24e %s %s" % (key, json.dumps(rows[key])))
        check(hit, "%s printed no %r line: %s" % (rel, line, lines[-5:]))
        check(all((got[k] > 0) == (k in want) for k in RNN_PATH),
              "%s launched %s: want %s" % (key, got, sorted(want)))
        check(not any(n for k, n in got.items() if k not in RNN_PATH),
              "%s launched %s: want K1-K3 and U1 only" % (key, got))
    return rows


def phase_rnn(mx, counters, rng, device):
    """Phase 24: the RNN layer on the card. Every kernel's count is set to
    0 before its main path (24a, 24c's steps, 24e) and read after it;
    only K1-K3 and U1 may launch."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    for c in counters.values():               # the RNN path starts here
        c.launches = 0
    mod, it, lm = phase_rnn_lm(mx, counters, rng)
    trained = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
    del mod
    vs_cpu = phase_rnn_card_vs_cpu(mx, counters, it, trained)
    gluon = phase_gluon_lstm(mx, counters, rng)
    path = launches_of(counters)
    modes = phase_rnn_modes(mx, counters, device)
    for k, c in counters.items():             # 24d's kernel checks are
        c.launches = path[k]                  # not the main path
    examples = phase_rnn_examples(mx, counters)
    rnn_launches = launches_of(counters)      # ... and ends here
    seconds = time.perf_counter() - t0
    log("phase 24 rnn %s" % json.dumps({
        "kernel_launches": rnn_launches, "seconds": seconds,
        "bucketed_tokens_per_s": lm["tokens_per_s"],
        "gluon_tokens_per_s": gluon["train"]["tokens_per_s"],
        "k1_captured": gluon["inference"]["captured"]}))
    check(all(rnn_launches[k] > 0 for k in RNN_PATH)
          and not any(n for k, n in rnn_launches.items()
                      if k not in RNN_PATH),
          "the RNN path launched %s: want K1-K3 and U1, and no other"
          % rnn_launches)
    return rnn_launches, {"lm": lm, "card_vs_cpu": vs_cpu, "gluon": gluon,
                          "modes": modes, "examples": examples,
                          "seconds": seconds}


# ---------------------------------------------------------------------------
# the CTC speech model and the rest of ops/nn.py (phase 25)
# ---------------------------------------------------------------------------
def speech_utterances(rng, n):
    """``n`` utterances by the example's ``make_utterance``
    (`examples/speech_recognition/train_am.py:32-43`): a label of
    SPEECH_LABELS symbols (1..28; 0 is the blank), each symbol's noisy
    template repeated for 2-4 frames. Returns [(frames (t, F), label)]."""
    templates = rng.randn(SPEECH_PHONES, SPEECH_FEAT).astype(np.float32) * 2
    lo, hi = SPEECH_LABELS
    utts = []
    for _ in range(n):
        labels = rng.randint(1, SPEECH_PHONES, size=rng.randint(lo, hi + 1))
        frames = []
        for ph in labels:
            reps = rng.randint(2, 5)
            frames.append(np.tile(templates[ph], (reps, 1))
                          + 0.15 * rng.randn(reps, SPEECH_FEAT))
        utts.append((np.concatenate(frames).astype(np.float32), labels))
    return utts


def speech_batches(mx, utts, ctx, buckets=None):
    """The example's bucketed batches on ``ctx``: each utterance in the
    shortest bucket that holds it, frames zero-padded to the bucket's
    length, labels 0-padded to the longest label, whole batches only,
    bucket by bucket (``buckets``, SPEECH_BUCKETS by default). Returns
    (batches, [(frames, label)] of each)."""
    buckets = buckets or SPEECH_BUCKETS
    by_bucket = {b: [] for b in buckets}
    for f, lab in utts:
        fit = [b for b in buckets if b >= len(f)]
        if fit:
            by_bucket[fit[0]].append((f, lab))
    batches, items = [], []
    for b in buckets:
        group = by_bucket[b]
        for i in range(0, len(group) - SPEECH_BATCH + 1, SPEECH_BATCH):
            chunk = group[i:i + SPEECH_BATCH]
            x = np.zeros((SPEECH_BATCH, b, SPEECH_FEAT), np.float32)
            y = np.zeros((SPEECH_BATCH, SPEECH_LABELS[1]), np.float32)
            for j, (f, lab) in enumerate(chunk):
                x[j, :len(f)] = f
                y[j, :len(lab)] = lab
            batches.append(mx.io.DataBatch(
                [mx.nd.array(x, ctx=ctx)], [mx.nd.array(y, ctx=ctx)],
                bucket_key=b, pad=0,
                provide_data=[("data", (SPEECH_BATCH, b, SPEECH_FEAT))],
                provide_label=[("ctc_label", (SPEECH_BATCH,
                                              SPEECH_LABELS[1]))]))
            items.append(chunk)
    return batches, items


def speech_symbol(mx, t, decode=False):
    """``am_symbol`` (`train_am.py:46-67`) at bucket length ``t``:
    FullyConnected + relu -> RNN(lstm, one layer) -> FullyConnected ->
    CTCLoss (blank first); with ``decode``, the example's scores-only
    graph (`train_am.py:138-153`) ending in a softmax."""
    data = mx.sym.Variable("data")
    proj = mx.sym.FullyConnected(
        mx.sym.Reshape(data, shape=(-1, SPEECH_FEAT)),
        num_hidden=SPEECH_HIDDEN, name="proj")
    proj = mx.sym.Activation(proj, act_type="relu")
    proj = mx.sym.Reshape(proj, shape=(-1, t, SPEECH_HIDDEN))
    rnn = mx.sym.RNN(mx.sym.transpose(proj, axes=(1, 0, 2)),
                     state_size=SPEECH_HIDDEN, num_layers=1, mode="lstm",
                     name="lstm")
    scores = mx.sym.FullyConnected(
        mx.sym.Reshape(rnn, shape=(-1, SPEECH_HIDDEN)),
        num_hidden=SPEECH_PHONES, name="cls")
    scores = mx.sym.Reshape(scores, shape=(t, -1, SPEECH_PHONES))
    if decode:
        return mx.sym.softmax(scores, axis=-1)
    return mx.sym.CTCLoss(scores, mx.sym.Variable("ctc_label"), name="ctc")


def speech_module(mx, ctx, optimizer, opt_params, arg_params=None):
    """The speech model's BucketingModule on ``ctx``, bound at the longest
    bucket, from ``arg_params`` or seeded Xavier."""
    def sym_gen(t):
        return speech_symbol(mx, t), ("data",), ("ctc_label",)
    key = max(SPEECH_BUCKETS)
    mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=key,
                                 context=ctx)
    mod.bind(data_shapes=[("data", (SPEECH_BATCH, key, SPEECH_FEAT))],
             label_shapes=[("ctc_label", (SPEECH_BATCH, SPEECH_LABELS[1]))])
    mx.random.seed(SEED)
    np.random.seed(SEED)
    mod.init_params(initializer=mx.init.Xavier(), arg_params=arg_params)
    mod.init_optimizer(optimizer=optimizer, optimizer_params=opt_params)
    return mod


def greedy_decode(probs):
    """The example's greedy CTC decode of (t, C) probabilities."""
    out, prev = [], -1
    for p in probs.argmax(axis=-1):
        if p != prev and p != 0:
            out.append(int(p))
        prev = p
    return out


def speech_profile():
    """Phase 25a's profiled step, run by ``chip_smoke.py --speech-profile``
    in a process of its own (``speech_profile_main``); returns its row.
    Late in this script's long process the tracer has lost kernels that
    the counters saw (K2 in six traces of a row, CTC's kernels in every
    trace, on an H100 at 700 W), while a fresh process traced them all."""
    return run_own_process("--speech-profile", SPEECH_PROFILE_TIMEOUT_S)


def speech_profile_main():
    """The speech model on gpu(0) with Adam (TF32 off), two steps of a
    300-frame batch, then one profiled step: device busy and wall ms, the
    idle share, the CTC kernels' device time beside K2's and K3's, and
    the step's launches by the wrappers' counters (K2, K3 and U1 exactly
    one each, no other). Up to PROFILE_ATTEMPTS traces are taken for one
    that holds K2, K3 and CTC's kernels; if none does, busy and the idle
    share are null. Prints the row as one JSON line."""
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops = mx.ops
    counters = {"fused_lstm": ops.fused_lstm,
                "fused_lstm_train": ops.fused_lstm_train,
                "lstm_bwd_recurrence": ops.lstm_bwd_recurrence,
                "conv1x1_s2_dgrad": ops.conv1x1_s2_dgrad,
                "flash_attention": ops.flash_attention, "rtc": mx.rtc.Kernel,
                "multi_tensor_update": ops.multi_tensor_update,
                "greedy_nms": ops.greedy_nms,
                "sparse_row_update": ops.sparse_row_update}
    utts = speech_utterances(np.random.RandomState(SEED + 25), SPEECH_UTTS)
    batches, _ = speech_batches(mx, utts, mx.gpu(0))
    batch = next(b for b in batches if b.bucket_key == max(SPEECH_BUCKETS))
    mod = speech_module(mx, mx.gpu(0), "adam", SPEECH_OPT)
    counted = {}

    def step():
        before = launches_of(counters)
        mod.forward_backward(batch)
        mod.update()
        counted.update(launched(counters, before))
    step()
    step()
    wall, kern = device_profile(
        step, complete=lambda kern: all(
            any(f in k for k in kern for f in frags)
            for frags in (K2_KERNELS, K3_KERNELS, ("ctc_loss",))))
    check(kern, "the profiler saw no device kernel in the speech step")
    busy = sum(v[1] for v in kern.values())
    ctc = {k: v for k, v in kern.items() if "ctc" in k.lower()}
    row = {"k2": kernel_share(kern, K2_KERNELS, busy),
           "k3": kernel_share(kern, K3_KERNELS, busy),
           "u1": kernel_share(kern, ("multi_tensor_kernel",), busy),
           "ctc": {"kernels": ctc, "ms": sum(v[1] for v in ctc.values())},
           "launches_counted": {k: n for k, n in counted.items() if n},
           "top": sorted(((k, v[1]) for k, v in kern.items()),
                         key=lambda kv: -kv[1])[:8]}
    row["traced"] = {"k2": bool(row["k2"]["launches"]),
                     "k3": bool(row["k3"]["launches"]), "ctc": bool(ctc)}
    whole = all(row["traced"].values())
    row.update(wall_ms=wall, device_busy_ms=busy if whole else None,
               device_idle_share=1 - busy / wall if whole else None)
    check(row["launches_counted"] == {"fused_lstm_train": 1,
                                      "lstm_bwd_recurrence": 1,
                                      "multi_tensor_update": 1},
          "the profiled step launched %s, want K2, K3 and U1 once each"
          % row["launches_counted"])
    print(json.dumps(row), flush=True)
    return 0


def phase_speech_train(mx, counters, rng):
    """Phase 25a: the speech model bucketed on gpu(0): a warm-up step on
    each bucket, then one epoch of ``forward_backward`` + ``update`` with
    Adam (frames/s by the host's clock between two synchronizes), the
    example's decode Module at batch 1 and 32, and one profiled step in a
    process of its own. K2 and K3 once a step, U1 once a step, K1 once a
    decode forward, and no other kernel."""
    utts = speech_utterances(rng, SPEECH_UTTS)
    batches, items = speech_batches(mx, utts, mx.gpu(0))
    check(sorted({b.bucket_key for b in batches}) == list(SPEECH_BUCKETS),
          "the utterances fill buckets %s, want %s"
          % (sorted({b.bucket_key for b in batches}), SPEECH_BUCKETS))
    mod = speech_module(mx, mx.gpu(0), "adam", SPEECH_OPT)
    before = launches_of(counters)
    warm = [next(b for b in batches if b.bucket_key == k)
            for k in SPEECH_BUCKETS]
    for batch in warm:
        mod.forward_backward(batch)
        mod.update()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches:
        mod.forward_backward(batch)
        mod.update()
        losses.append(mod.get_outputs()[0].copy())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train = launched(counters, before)
    steps = len(warm) + len(batches)
    losses = [l.asnumpy() for l in losses]
    padded = sum(SPEECH_BATCH * b.bucket_key for b in batches)
    spoken = sum(len(f) for chunk in items for f, _ in chunk)
    # the loss a label symbol: batches of longer buckets carry longer labels
    per_symbol = [float(l.sum()) / sum(len(lab) for _, lab in chunk)
                  for l, chunk in zip(losses, items)]
    n_first = max(1, len(losses) // 5)
    summary = {
        "utterances": SPEECH_UTTS, "buckets": list(SPEECH_BUCKETS),
        "batches_an_epoch": len(batches),
        "batches_by_bucket": {k: sum(b.bucket_key == k for b in batches)
                              for k in SPEECH_BUCKETS},
        "epoch_wall_s": wall, "frames_per_s": padded / wall,
        "utterance_frames_per_s": spoken / wall,
        "steps_per_s": len(batches) / wall,
        "first_batches_loss_a_symbol": float(np.mean(per_symbol[:n_first])),
        "last_batches_loss_a_symbol": float(np.mean(per_symbol[-n_first:])),
        "launches_train": train, "steps": steps}
    check(all(np.isfinite(l).all() and l.shape == (SPEECH_BATCH,)
              for l in losses), "the speech model's losses: not finite or "
          "not one a sample")
    check(summary["last_batches_loss_a_symbol"]
          < summary["first_batches_loss_a_symbol"],
          "the epoch did not lower the CTC loss a label symbol: %s"
          % per_symbol)
    check(train["fused_lstm_train"] == steps
          and train["lstm_bwd_recurrence"] == steps,
          "training launched K2 %d and K3 %d times in %d steps, want one a "
          "step" % (train["fused_lstm_train"], train["lstm_bwd_recurrence"],
                    steps))
    check(train["multi_tensor_update"] == steps,
          "Adam launched U1 %d times in %d steps, want one a step"
          % (train["multi_tensor_update"], steps))
    check(not any(n for k, n in train.items()
                  if k not in ("fused_lstm_train", "lstm_bwd_recurrence",
                               "multi_tensor_update")),
          "training launched %s: want K2, K3 and U1 only" % train)

    arg_params, aux_params = mod.get_params()
    arg_params = {k: v for k, v in arg_params.items()
                  if not k.endswith("state") and not k.endswith("state_cell")}
    t = max(SPEECH_BUCKETS)
    longest = [b for b in batches if b.bucket_key == t]
    decode = {}
    for bs in (1, SPEECH_BATCH):
        infer = mx.mod.Module(speech_symbol(mx, t, decode=True),
                              data_names=("data",), label_names=None,
                              context=mx.gpu(0))
        infer.bind(data_shapes=[("data", (bs, t, SPEECH_FEAT))],
                   for_training=False)
        infer.set_params(arg_params, aux_params, allow_missing=True)
        x = longest[0].data[0].asnumpy()
        inputs = [x[j:j + 1] for j in range(SPEECH_DECODE)] if bs == 1 \
            else [x]
        before = launches_of(counters)
        compiles = mx.compiled.compile_counts()["compiles"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs = []
        for xi in inputs:
            infer.forward(mx.io.DataBatch([mx.nd.array(xi, ctx=mx.gpu(0))]),
                          is_train=False)
            probs.append(infer.get_outputs()[0].asnumpy())
        ms = (time.perf_counter() - t0) * 1e3 / len(inputs)
        got = launched(counters, before)
        new = mx.compiled.compile_counts()["compiles"] - compiles
        chunk = items[batches.index(longest[0])]
        hyps = [greedy_decode(p[:len(chunk[j][0]), 0]) for j, p in
                enumerate(probs)] if bs == 1 else \
            [greedy_decode(probs[0][:len(f), j]) for j, (f, _) in
             enumerate(chunk)]
        right = sum(h == list(chunk[j][1]) for j, h in enumerate(hyps))
        decode[bs] = {"forwards": len(inputs), "host_ms_a_forward": ms,
                      "launches": got, "compiles": new,
                      "sequences_right": right,
                      "sequences": len(hyps)}
        check(all(p.shape == (t, bs, SPEECH_PHONES) and np.isfinite(p).all()
                  and np.allclose(p.sum(-1), 1.0, atol=1e-4) for p in probs),
              "the decode Module's probabilities at batch %d" % bs)
        # the first forward compiles: its capture's warm-up runs launch K1
        # too, then a replay a forward
        want = len(inputs) + mx.compiled.WARMUP_RUNS * new
        check(new == 1 and got["fused_lstm"] == want
              and not any(n for k, n in got.items() if k != "fused_lstm"),
              "decoding at batch %d compiled %d signatures and launched %s: "
              "want one, and K1 %d times (once a forward and a warm-up run)"
              % (bs, new, got, want))
    summary["decode"] = decode
    summary["profile"] = speech_profile()
    log("phase 25a speech model %s" % json.dumps(summary))
    return summary


def speech_steps(mx, ctx, weights, batches):
    """2 SGD steps (SPEECH_CHECK_OPT) of the speech model on ``ctx`` from
    ``weights``, one a batch: [(per-sample losses, gradients, updates)]."""
    mod = speech_module(mx, ctx, "sgd", SPEECH_CHECK_OPT, weights)
    out = []
    for batch in batches:
        before = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
        mod.forward_backward(batch)
        loss = mod.get_outputs()[0].asnumpy()
        grads = grads_of(mod._curr_module)
        mod.update()
        after = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
        out.append((loss, grads, {n: after[n] - before[n] for n in after}))
    return out


def drop_last_symbol(mx, batch):
    """The (host) batch with the last symbol of each label dropped (set
    to the padding 0): a control."""
    y = batch.label[0].asnumpy().copy()
    for row in y:
        row[np.flatnonzero(row)[-1]] = 0.0
    return mx.io.DataBatch(batch.data, [mx.nd.array(y, ctx=mx.cpu())],
                           bucket_key=batch.bucket_key, pad=0,
                           provide_data=batch.provide_data,
                           provide_label=batch.provide_label)


def speech_readings(got, want):
    """Per step: the per-sample losses' largest relative difference, and
    the largest relative norm over the parameters of the gradients and of
    the updates."""
    rows = []
    for (gl, gg, gu), (wl, wg, wu) in zip(got, want):
        rows.append({
            "loss_rel": float(np.max(np.abs(gl - wl) / np.abs(wl))),
            "grad_rel": leaf_errs(gg, wg)["max"],
            "update_rel": leaf_errs(gu, wu)["max"]})
    return {k: max(r[k] for r in rows) for k in rows[0]}, rows


def phase_speech_card_vs_cpu(mx, rng):
    """Phase 25b: 2 SGD steps from the seed over buckets 100 and 200 on
    gpu(0) and on cpu(): the per-sample CTC losses elementwise, each
    parameter's gradient and update by relative norm, within
    SPEECH_LOSS_REL / SPEECH_GRAD_REL; the control (the card's steps with
    each label's last symbol dropped) must fail both."""
    utts = speech_utterances(rng, 12 * SPEECH_BATCH)
    batches, _ = speech_batches(mx, utts, mx.cpu(), SPEECH_BUCKETS[:2])
    picked = [next(b for b in batches if b.bucket_key == k)
              for k in SPEECH_BUCKETS[:2]]
    seed_mod = speech_module(mx, mx.gpu(0), "sgd", SPEECH_CHECK_OPT)
    weights = {n: a.asnumpy() for n, a in seed_mod.get_params()[0].items()}
    del seed_mod
    want = speech_steps(mx, mx.cpu(), weights, picked)
    got = speech_steps(mx, mx.gpu(0), weights, picked)
    ctrl = speech_steps(mx, mx.gpu(0), weights,
                        [drop_last_symbol(mx, b) for b in picked])
    sound, sound_steps = speech_readings(got, want)
    control, _ = speech_readings(ctrl, want)
    summary = {"buckets": [b.bucket_key for b in picked], "sound": sound,
               "sound_steps": sound_steps, "control": control,
               "limits": {"loss_rel": SPEECH_LOSS_REL,
                          "grad_rel": SPEECH_GRAD_REL,
                          "update_rel": SPEECH_GRAD_REL}}
    log("phase 25b speech card vs cpu %s" % json.dumps(summary))
    for key, limit in summary["limits"].items():
        check(sound[key] <= limit, "25b %s %.3g above its limit %g"
              % (key, sound[key], limit))
        check(control[key] > limit, "25b's control %s %.3g does not fail "
              "its limit %g" % (key, control[key], limit))
    return summary


def phase_nn_rest_ops(mx):
    """Phase 25c: the rest of ops/nn.py at full size on gpu(0) against
    cpu() (`tools/nn_rest_sweep.py`'s card cases, TF32 off): each case's
    forward and gradient readings within its family's limit, each
    family's control (the card's inputs rounded to bf16) above it;
    CTCLoss 20 calls on the card within the limit, and the CTC route
    PyTorch takes on the op's arguments; a hybridized
    ``gluon.loss.CTCLoss`` counted as uncaptured."""
    from mxnet_tpu_torch import compiled
    from mxnet_tpu_torch.tools import detection_sweep, nn_rest_sweep as sw
    rows, controls, worst = [], {}, {}
    cases = sw.card_cases()
    for case in cases:
        want = sw.run_case(case, mx.cpu())
        got = sw.run_case(case, mx.gpu(0))
        bad = sw.run_case(case, mx.gpu(0), detection_sweep._bf16_rounded)
        fwd, grad = (sw.reading(got[0], want[0], case.family),
                     sw.reading(got[1], want[1], case.family, norm=True))
        ctl = max(sw.reading(bad[0], want[0], case.family),
                  sw.reading(bad[1], want[1], case.family, norm=True))
        if case.name == "CTCLoss":
            for _ in range(DETERMINISM_CALLS - 1):
                again = sw.run_case(case, mx.gpu(0))
                fwd = max(fwd, sw.reading(again[0], want[0], case.family))
                grad = max(grad, sw.reading(again[1], want[1], case.family,
                                            norm=True))
        worst[case.family] = max(worst.get(case.family, 0.0), fwd, grad)
        controls[case.family] = max(controls.get(case.family, 0.0), ctl)
        rows.append({"op": case.name, "params": {
            k: v for k, v in case.params.items()},
            "shapes": [list(a.shape) for a in case.arrays],
            "forward": fwd, "gradient": grad, "control": ctl})
    log("phase 25c ops %s" % json.dumps(rows))
    for fam, limit in sw.LIMITS.items():
        check(worst.get(fam, 0.0) <= limit, "25c family %s reads %.3g, "
              "limit %g" % (fam, worst.get(fam, 0.0), limit))
        check(controls.get(fam, 0.0) > limit, "25c family %s's control "
              "%.3g does not fail its limit %g"
              % (fam, controls.get(fam, 0.0), limit))

    # the route: PyTorch's own choice on the arguments the op passes it
    # (cuDNN takes only int32 targets on the host); 25a's profiled step
    # shows the kernels it ran
    from mxnet_tpu_torch.ops.nn import _ctc_label_lengths
    ctc = next(c for c in cases if c.name == "CTCLoss")
    dev = mx.gpu(0).torch_device()
    data, label = (torch.from_numpy(a).to(dev) for a in ctc.arrays[:2])
    lab = label.long()
    T, B, _ = data.shape
    cudnn = bool(torch._use_cudnn_ctc_loss(
        torch.log_softmax(data.float(), -1), lab.clamp(min=0),
        torch.full((B,), T, dtype=torch.long, device=dev),
        _ctc_label_lengths(lab, lab == 0), 0))
    route = "cudnn" if cudnn else "native"

    rng = np.random.RandomState(SEED + 253)
    pred = rng.randn(SPEECH_BATCH, 50, SPEECH_PHONES).astype(np.float32)
    label = np.full((SPEECH_BATCH, 12), -1.0, np.float32)
    for j in range(SPEECH_BATCH):
        n = rng.randint(1, 13)
        label[j, :n] = rng.randint(0, SPEECH_PHONES - 1, n)
    before = compiled.compile_counts()
    loss = mx.gluon.loss.CTCLoss()
    loss.hybridize()
    outs = [loss(mx.nd.array(pred, ctx=mx.gpu(0)),
                 mx.nd.array(label, ctx=mx.gpu(0))).asnumpy()
            for _ in range(2)]
    after = compiled.compile_counts()
    host = mx.gluon.loss.CTCLoss()(mx.nd.array(pred, ctx=mx.cpu()),
                                   mx.nd.array(label, ctx=mx.cpu()))
    hybrid = {"uncaptured": after["uncaptured"] - before["uncaptured"],
              "vs_cpu": max(float(np.abs(o - host.asnumpy()).max()
                                  / np.abs(host.asnumpy()).max())
                            for o in outs)}
    summary = {"worst": worst, "controls": controls, "limits": sw.LIMITS,
               "ctc_route": route,
               "ctc_calls_within_limit": DETERMINISM_CALLS,
               "hybridized_gluon_ctc": hybrid}
    log("phase 25c summary %s" % json.dumps(summary))
    check(hybrid["uncaptured"] >= 1 and hybrid["vs_cpu"] <= sw.LIMITS["ctc"],
          "the hybridized gluon CTCLoss on the card: %s" % hybrid)
    return summary


def phase_speech_examples(mx, counters):
    """Phase 25d: the six examples of this slice and the eleven that ran
    on the port untested before it, through ``tools/run_example`` on
    gpu(0) at their JAX tests' arguments, each printing its JAX test's
    line, with their kernel launches."""
    from mxnet_tpu_torch.tools.run_example import run_example
    rows = {}
    for key, rel, argv, line in SPEECH_EXAMPLES + A14_EXAMPLES:
        before = launches_of(counters)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            run_example(os.path.join("examples", rel), argv, "gpu")
        lines = buf.getvalue().splitlines()
        got = launched(counters, before)
        hit = [ln for ln in lines if line in ln]
        rows[key] = {"line": hit[0] if hit else None,
                     "launches": {k: n for k, n in got.items() if n},
                     "seconds": time.perf_counter() - t0}
        log("phase 25d %s %s" % (key, json.dumps(rows[key])))
        check(hit, "%s printed no %r line: %s" % (rel, line, lines[-5:]))
    speech = rows["speech_am"]["launches"]
    check(all(speech.get(k, 0) > 0 for k in RNN_PATH),
          "train_am.py launched %s: want K1-K3 and U1" % speech)
    return rows


def phase_speech(mx, counters, rng):
    """Phase 25: the CTC speech model and the rest of ops/nn.py on the
    card. Every kernel's count is set to 0 before its main path (25a's
    training and decoding, 25b's steps, 25d's examples) and read after
    it; only K1-K3 and U1 may launch."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    for c in counters.values():               # the speech path starts here
        c.launches = 0
    train = phase_speech_train(mx, counters, rng)
    vs_cpu = phase_speech_card_vs_cpu(mx, rng)
    path = launches_of(counters)
    ops = phase_nn_rest_ops(mx)
    for k, c in counters.items():             # 25c's op checks are not
        c.launches = path[k]                  # the main path
    examples = phase_speech_examples(mx, counters)
    launches = launches_of(counters)          # ... and ends here
    seconds = time.perf_counter() - t0
    log("phase 25 speech %s" % json.dumps({
        "kernel_launches": launches, "seconds": seconds,
        "frames_per_s": train["frames_per_s"],
        "epoch_wall_s": train["epoch_wall_s"],
        "epoch_steps": train["batches_an_epoch"],
        "device_idle_share": train["profile"]["device_idle_share"],
        "ctc_route": ops["ctc_route"]}))
    check(all(launches[k] > 0 for k in RNN_PATH)
          and not any(n for k, n in launches.items() if k not in RNN_PATH),
          "the speech path launched %s: want K1-K3 and U1, and no other"
          % launches)
    return launches, {"train": train, "card_vs_cpu": vs_cpu,
                      "ops": ops, "examples": examples, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 26: the observability stack on the ResNet-50 path (a process of its
# own, `python3 chip_smoke.py --observability`)
# ---------------------------------------------------------------------------
# 26a: fit steps with the stack off, then on (stepprof's sampled sync every
# OBS_SYNC_EVERY steps, runprof and memprof on), after OBS_WARMUP steps that
# count the step's FLOPs; OBS_STAGED staged batches, reused in turn
OBS_WARMUP, OBS_STEPS, OBS_SYNC_EVERY, OBS_STAGED = 3, 20, 5, 4
# the stack's cost at sync-every 5, as the on run's extra wall over the off
# run's. A sampled step once held the card 1.5x a step's host time h and
# ran its busy time b after it, about (0.5 h + b) / 5 h: 0.24 at h = 90
# ms, b = 66 ms; read 0.162-0.327 (H100 80GB HBM3, 700 W); the limit above
# those. The segmented holds (module._Holds) keep the card at most a
# hold behind the host, and cost less
OBS_OVERHEAD_LIMIT = 0.5
# the sampled device_compute p50 against the traced step's busy time
OBS_DEVICE_REL = 0.15
# 26b: the trace's K5 time against CUDA events of the same calls, and the
# trace table's total against the trace's busy time
OBS_K5_TRACE_REL, OBS_TABLE_BUSY_REL = 0.10, 0.05
OBS_TRACED_STEPS = 3
# 26c: the step's counted FLOPs against the symbol's
OBS_FLOP_REL = 0.02
# 26d: the leak sentinel's window and the steps of the clean and the
# leaking loops (each polls memprof once a step)
OBS_LEAK_WINDOW, OBS_LEAK_STEPS = 8, 12
# 26e: a bf16 stat against its f32 recomputation: the stat is rounded to
# bf16 once (2^-8 relative), plus the f32 sum's order
OBS_STAT_REL = 2.0 ** -7
# 26f: Gluon steps
OBS_GLUON_STEPS = 10
# 26g: fit steps of the telemetry subprocess
OBS_TELEMETRY_STEPS = 5
OBS_TIMEOUT_S = 600
# 26h: the examples of the slice, at their JAX tests' arguments
OBS_EXAMPLES = [("profiler/profiler_example.py", [], "PROFILER EXAMPLE OK"),
                ("profiler/profiler_example.py", ["--trace"],
                 "PROFILER EXAMPLE OK"),
                ("python-howto/data_and_ops.py", [], "PYTHON HOWTO OK")]
K5_TRACE_KERNEL = "dgrad_wgmma"


def staged_iter(mx, batches, steps):
    """A DataIter over staged batches, ``steps`` of them in turn."""
    class Staged(mx.io.DataIter):
        def __init__(self):
            super().__init__()
            self.provide_data = [("data", tuple(batches[0].data[0].shape))]
            self.provide_label = [("softmax_label",
                                   tuple(batches[0].label[0].shape))]
            self.i = 0

        def reset(self):
            self.i = 0

        def next(self):
            if self.i == steps:
                raise StopIteration
            self.i += 1
            return batches[(self.i - 1) % len(batches)]
    return Staged()


def obs_stack(mx, on):
    """The stack on (stepprof verbose with its sampled sync, runprof and
    memprof, FLOP counting) or off (every kill switch)."""
    for name in ("MXNET_XLA_STATS", "MXNET_RUNPROF", "MXNET_MEMPROF"):
        os.environ[name] = "1" if on else "0"
    if on:
        mx.stepprof.enable(sync_every=OBS_SYNC_EVERY)
    else:
        mx.stepprof.disable()


def obs_fit(mx, mod, batches, steps):
    """``fit`` over ``steps`` staged batches: wall seconds between
    synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(staged_iter(mx, batches, steps), num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": RESNET_LR, "momentum": 0.9})
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def sync_warnings(fn):
    """The synchronizing calls PyTorch warns of while ``fn`` runs: each
    warning's message and where it was raised."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sorted("%s:%d %s" % (os.path.basename(w.filename), w.lineno,
                                str(w.message)[:80])
                  for w in seen
                  if "called a synchronizing" in str(w.message))


def symbol_flops(sym, data_shape):
    """The independent count of a train step's model FLOPs from the
    traced symbol: 2 x MACs of every Convolution and FullyConnected
    forward, plus its weight gradient, plus its input gradient unless it
    reads the data."""
    internals = sym.get_internals()
    arg_shapes, out_shapes, _ = internals.infer_shape(data=data_shape)
    shape_of = dict(zip(internals.list_outputs(), out_shapes))
    shape_of.update(zip(internals.list_arguments(), arg_shapes))
    total = 0
    for node in sym._topo_nodes():
        if node.is_var() or node.op not in ("Convolution",
                                            "FullyConnected"):
            continue
        macs = int(np.prod(shape_of[node.name + "_output"])) * \
            int(np.prod(shape_of[node.inputs[1][0].name][1:]))
        total += 2 * macs * (2 if node.inputs[0][0].is_var() else 3)
    return total


def k5_step_flops():
    """K5's analytic FLOPs of one step: 2 N Ho Wo K C at the six sites."""
    return sum(2 * n * ho * wo * k * c for n, ho, wo, k, c in K5_SHAPES)


def phase_obs_stack(mx, mod, batches, counters):
    """26a: the stack off, then on; the sampled device_compute against a
    traced step; the verdict; launches and compile counts."""
    k5, u1 = counters["conv1x1_s2_dgrad"], counters["multi_tensor_update"]
    obs_stack(mx, True)
    obs_fit(mx, mod, batches, OBS_WARMUP)        # counts the FLOPs
    syncs = {"stack_off": [], "stepprof_off": []}
    for _ in range(2):
        obs_stack(mx, False)
        syncs["stack_off"].append(sync_warnings(
            lambda: mod._step(batches[0])))
        obs_stack(mx, True)
        mx.stepprof.disable()                    # the default: verbose off
        syncs["stepprof_off"].append(sync_warnings(
            lambda: mod._step(batches[0])))
    obs_stack(mx, False)
    before = mx.compiled.compile_counts()
    off_wall = obs_fit(mx, mod, batches, OBS_STEPS)
    off_counts = {k: v - before[k]
                  for k, v in mx.compiled.compile_counts().items()}
    obs_stack(mx, True)
    mx.stepprof.reset()
    mx.memprof.reset()
    before = mx.compiled.compile_counts()
    k5_before, u1_before = k5.launches, u1.launches
    on_wall = obs_fit(mx, mod, batches, OBS_STEPS)
    on_counts = {k: v - before[k]
                 for k, v in mx.compiled.compile_counts().items()}
    k5_n, u1_n = k5.launches - k5_before, u1.launches - u1_before
    shares = mx.stepprof.shares()
    verdict, hint = mx.stepprof.verdict()
    samples = sorted(mx.stepprof.profiler._device_samples)
    sampled_ms = float(np.median(samples)) * 1e3 if samples else None
    mx.stepprof.disable()
    traced = profiled_step(lambda: mod._step(batches[0]))
    busy = traced["device_busy_ms"]
    row = {
        "off_imgs_per_s": OBS_STEPS * RESNET_BATCH / off_wall,
        "on_imgs_per_s": OBS_STEPS * RESNET_BATCH / on_wall,
        "overhead": on_wall / off_wall - 1,
        "syncs_a_step": syncs,
        "shares": shares, "shares_sum": sum(shares.values()),
        "verdict": verdict, "hint": hint,
        "device_samples_ms": [s * 1e3 for s in samples],
        "samples_dropped": mod.samples_dropped,
        "sampled_device_compute_p50_ms": sampled_ms,
        "traced_busy_ms": busy, "traced_wall_ms": traced["step_wall_ms"],
        "overlap": mx.stepprof.overlap(),
        "k5_launches": k5_n, "u1_launches": u1_n,
        "compile_counts": {"off": off_counts, "on": on_counts}}
    print(json.dumps({"phase": "26a", **row}), flush=True)
    check(row["overhead"] <= OBS_OVERHEAD_LIMIT,
          "the stack costs %.3f of the step, limit %.2f"
          % (row["overhead"], OBS_OVERHEAD_LIMIT))
    # U1's pinned ring waits on a slot's event now and then (at most once
    # a call): the calls are compared by where they come from
    seen_off = {w for step in syncs["stack_off"] for w in step}
    seen_on = {w for step in syncs["stepprof_off"] for w in step}
    check(seen_on <= seen_off, "the step with stepprof off synchronizes at "
          "%s, which the step with the stack off does not"
          % sorted(seen_on - seen_off))
    check(abs(row["shares_sum"] - 1) <= 0.01, "stepprof's shares sum to %s"
          % row["shares_sum"])
    check(sampled_ms is not None
          and abs(sampled_ms - busy) <= OBS_DEVICE_REL * busy,
          "the sampled device_compute p50 %s ms vs the traced busy %.3f ms"
          % (sampled_ms, busy))
    check(k5_n == K5_PER_STEP * OBS_STEPS and u1_n == OBS_STEPS,
          "%d steps launched K5 %d and U1 %d times" % (OBS_STEPS, k5_n,
                                                        u1_n))
    check(on_counts == off_counts, "compile counts with the stack on %s, "
          "off %s" % (on_counts, off_counts))
    return row


def k5_event_ms(mx):
    """CUDA-event time of the 18 K5 calls of OBS_TRACED_STEPS steps: each
    site's bf16 shape timed alone (``time_ms``), summed over the sites,
    times the steps."""
    ops = mx.ops
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    total = 0.0
    for n, ho, wo, k, c in K5_SHAPES:
        dy = torch.randn((n, ho, wo, k), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        w2 = torch.randn((k, c), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        total += time_ms(lambda: ops.conv1x1_s2_dgrad(dy, w2, 2 * ho,
                                                      2 * wo), 10)
    return total * OBS_TRACED_STEPS


def phase_obs_trace(mx, mod, batches, counters, tmp):
    """26b: profiler tracing over OBS_TRACED_STEPS steps, then the trace
    table: K5's launches against the counter, its time against CUDA
    events, the table's total against the trace's busy time. A trace
    that lost K5 launches is taken again (PROFILE_ATTEMPTS); the table is
    never filled in from the counters. CUDA events around the traced
    steps, the host's clock and the SM clock before and after each trace
    are printed beside the trace's durations (ROADMAP C.16: one trace
    read every duration at 0.476x; these say which clock moved)."""
    k5 = counters["conv1x1_s2_dgrad"]
    clocks = []
    for attempt in range(PROFILE_ATTEMPTS):
        if attempt:
            time.sleep(PROFILE_PAUSE_S * attempt)
        logdir = os.path.join(tmp, "trace%d" % attempt)
        mx.profiler.set_config(filename=logdir + ".json")
        torch.cuda.synchronize()
        before = k5.launches
        sm_before = sm_clock_mhz()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        mx.profiler.set_state("run")
        t0 = time.perf_counter()
        start.record()
        for b in batches[:OBS_TRACED_STEPS]:
            mod._step(b)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        mx.profiler.set_state("stop")
        clocks.append({"attempt": attempt,
                       "steps_event_ms": start.elapsed_time(end),
                       "steps_host_ms": host_ms,
                       "sm_clock_mhz": [sm_before, sm_clock_mhz()]})
        counted = k5.launches - before
        table = mx.xplane.op_table(logdir + "_trace")
        k5_rows = {k: v for k, v in table.items() if K5_TRACE_KERNEL in k}
        traced = sum(v["count"] for v in k5_rows.values())
        if traced == counted:
            break
    k5_trace_ms = sum(v["total_ps"] for v in k5_rows.values()) / 1e9
    total_ms = sum(v["total_ps"] for v in table.values()) / 1e9
    busy_ms = mx.xplane.busy_us(logdir + "_trace") / 1e3
    events_ms = k5_event_ms(mx)
    dumps = mx.profiler.device_dumps(top=8)
    row = {"attempts": attempt + 1, "k5_traced_launches": traced,
           "k5_counted_launches": counted, "k5_kernels": sorted(k5_rows),
           "k5_trace_ms": k5_trace_ms, "k5_events_ms": events_ms,
           "table_total_ms": total_ms, "trace_busy_ms": busy_ms,
           "traced_steps_clocks": clocks,
           "trace_busy_over_steps_events": busy_ms / clocks[-1][
               "steps_event_ms"],
           "table": dumps.splitlines()[:14]}
    print(json.dumps({"phase": "26b", **row}), flush=True)
    check(traced == counted == K5_PER_STEP * OBS_TRACED_STEPS,
          "the trace table holds %d K5 launches, the counter %d, want %d"
          % (traced, counted, K5_PER_STEP * OBS_TRACED_STEPS))
    check(abs(k5_trace_ms - events_ms) <= OBS_K5_TRACE_REL * events_ms,
          "K5's traced time %.3f ms vs CUDA events %.3f ms"
          % (k5_trace_ms, events_ms))
    check(abs(total_ms - busy_ms) <= OBS_TABLE_BUSY_REL * busy_ms,
          "the table's total %.3f ms vs the trace's busy %.3f ms"
          % (total_ms, busy_ms))
    return row


def sm_clock_mhz():
    """The card's SM clock now, by ``nvidia-smi`` (None where it does not
    answer)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits", "--id=0"], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def phase_obs_mfu(mx, mod, row_a, card):
    """26c: the counted FLOPs against the symbol's, a control without
    K5's term, and goodput at 26a's rate."""
    counted = mx.xla_stats.flops_per_batch()
    want = symbol_flops(mod.symbol, (RESNET_BATCH,) + IMAGE)
    control = counted - k5_step_flops()
    rate = row_a["on_imgs_per_s"] / RESNET_BATCH
    good = mx.xla_stats.goodput(rate, 1.0)
    row = {"flops_per_batch": counted, "symbol_flops": want,
           "rel": abs(counted - want) / want,
           "control_without_k5": control,
           "control_rel": abs(control - want) / want,
           "peak_flops": mx.xla_stats.peak_flops_per_device(),
           "goodput": good, "card": card}
    print(json.dumps({"phase": "26c", **row}), flush=True)
    check(row["rel"] <= OBS_FLOP_REL, "counted FLOPs %d vs the symbol's %d"
          % (counted, want))
    check(row["control_rel"] > OBS_FLOP_REL, "the control without K5's "
          "term meets the %.2f limit" % OBS_FLOP_REL)
    check(row["peak_flops"] == 989e12 and good is not None
          and 0 < good["mfu"] < 1, "peak %s, goodput %s"
          % (row["peak_flops"], good))
    return row


def oom_block(mx, nbytes):
    """A hybridized block whose forward allocates ``nbytes``."""
    class Big(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.zeros((nbytes // 4,), ctx=x.context) + x.sum()
    big = Big()
    big.hybridize()
    return big


def nbytes_of(state):
    """The bytes of an optimizer state: an NDArray, None or a tuple of
    them."""
    if state is None:
        return 0
    if isinstance(state, (list, tuple)):
        return sum(nbytes_of(s) for s in state)
    return state.data.nbytes


def telemetry_count(mx, name, **labels):
    m = mx.telemetry.get_metric(name, **labels)
    return 0.0 if m is None else m.value


def phase_obs_memory(mx, mod, batches, tmp):
    """26d: the ledger, the timeline's peak, the leak sentinel and its
    control, a real over-allocation and the chaos site."""
    led = {sec: b for (scope, sec), b in mx.xla_stats.ledger().items()
           if scope == mod._ledger_scope()}
    ex = mod._exec
    want = {"params": sum(ex.arg_dict[n].data.nbytes
                          for n in mod._param_names),
            "grads": sum(g.data.nbytes for g in ex.grad_dict.values()),
            "aux": sum(a.data.nbytes for a in ex.aux_dict.values()),
            "optimizer": sum(nbytes_of(s)
                             for s in mod._updater.states.values())}
    rec = mx.memprof.sample("26d", force=True)
    peak = torch.cuda.max_memory_allocated()
    os.environ.update(MXNET_MEMPROF_SAMPLE_EVERY="1",
                      MXNET_MEMPROF_WINDOW=str(OBS_LEAK_WINDOW))
    leaks = []
    for leaking in (False, True):
        mx.memprof.reset()
        kept = []
        before = telemetry_count(mx, "run_anomalies_total",
                                 kind="memory_leak")
        for i in range(OBS_LEAK_STEPS):
            mod._step(batches[i % len(batches)])
            if leaking:
                kept.append(mod.get_outputs()[0].data.clone())
        leaks.append(telemetry_count(mx, "run_anomalies_total",
                                     kind="memory_leak") - before)
        del kept
    os.environ.pop("MXNET_MEMPROF_SAMPLE_EVERY")
    os.environ.pop("MXNET_MEMPROF_WINDOW")
    os.environ["MXNET_TELEMETRY_DIR"] = tmp
    before_oom = torch.cuda.memory_allocated()
    # the allocator's cache counts as used in mem_get_info: empty it, so
    # that the request exceeds what the allocator could find
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    nbytes = (free // 2 ** 30 + 2) * 2 ** 30
    big = oom_block(mx, nbytes)
    try:
        big(mx.nd.ones((1,), ctx=mx.gpu(0)))
        oom = None
    except mx.memprof.DeviceOOMError as exc:
        oom = exc
    allocated = {"before_oom": before_oom,
                 "after_oom": torch.cuda.memory_allocated()}
    real = {"requested": nbytes, "free": free,
            "parsed": getattr(oom, "requested_bytes", None),
            "verdict": getattr(oom, "verdict", None),
            "dump": getattr(oom, "dump_path", None)}
    del big
    torch.cuda.empty_cache()
    mod._step(batches[0])                        # the card keeps training
    trained = bool(torch.isfinite(mod.get_outputs()[0].data).all())
    with mx.chaos.armed("memory.oom", value=str(5 * 2 ** 30)):
        try:
            mod._step(batches[0])
            chaos = None
        except mx.memprof.DeviceOOMError as exc:
            chaos = exc
    os.environ.pop("MXNET_TELEMETRY_DIR")
    chaos_row = {"parsed": getattr(chaos, "requested_bytes", None),
                 "dump": getattr(chaos, "dump_path", None)}
    del oom, chaos          # their tracebacks hold the failed calls' frames
    import gc
    gc.collect()
    allocated["end"] = torch.cuda.memory_allocated()
    row = {"ledger": led, "tensor_bytes": want,
           "sample_peak": rec["devices"][0]["peak"] if rec["devices"]
           else None,
           "max_memory_allocated": peak, "leak_trips": {
               "clean": leaks[0], "leaking": leaks[1]},
           "oom": real, "trained_after_oom": trained, "chaos": chaos_row,
           "allocated": allocated}
    print(json.dumps({"phase": "26d", **row}), flush=True)
    check(all(led.get(k) == v for k, v in want.items()),
          "the ledger %s vs the tensors' bytes %s" % (led, want))
    check(row["sample_peak"] == peak, "the timeline's peak %s vs "
          "max_memory_allocated %d" % (row["sample_peak"], peak))
    check(leaks == [0, 1], "leak trips clean %d, leaking %d, want 0 and 1"
          % tuple(leaks))
    check(allocated["end"] <= allocated["before_oom"] + 2 ** 30,
          "memory after the OOM checks: %s" % allocated)
    check(real["parsed"] == nbytes and real["dump"]
          and os.path.exists(real["dump"]) and trained,
          "the over-allocation: %s, trained after it: %s" % (real, trained))
    check(chaos_row["parsed"] == 5 * 2 ** 30
          and chaos_row["dump"], "the chaos site: %s" % chaos_row)
    return row


def phase_obs_monitor(mx, mod, batches, counters):
    """26e: Monitor on the ResNet Module (``.*conv.*``) with the default
    stat and with ``nan_count``; a NaN batch books its anomaly."""
    k5 = counters["conv1x1_s2_dgrad"]
    pattern = re.compile(".*conv.*")
    want = sorted(n.name + "_output" for n in mod.symbol._topo_nodes()
                  if not n.is_var() and pattern.match(n.name + "_output"))
    f32 = {}

    def stat(x):
        f32[len(f32)] = float(x.data.float().abs().mean())
        return x.abs().mean()
    mon = mx.monitor.Monitor(1, stat_func=stat, pattern=".*conv.*")
    mod.install_monitor(mon)
    before = k5.launches
    mon.tic()
    mod.forward_backward(batches[0])
    mod.update()
    torch.cuda.synchronize()
    launched = k5.launches - before
    res = mon.toc()
    worst = max(abs(float(v) - f32[i]) / max(abs(f32[i]), 1e-30)
                for i, (_, _, v) in enumerate(res))
    nan_mon = mx.monitor.Monitor(1, stat_func=mx.monitor.nan_count,
                                 pattern=".*conv.*")
    mod.install_monitor(nan_mon)
    anomalies = []
    bad = batches[1].data[0].data.clone()
    bad[0, 0, 0, 0] = float("nan")
    nan_batch = mx.io.DataBatch(data=[mx.nd.NDArray(bad, mx.gpu(0))],
                                label=batches[1].label)
    for batch in (batches[1], nan_batch):
        before = telemetry_count(mx, "run_anomalies_total",
                                 kind="nonfinite_tensor")
        nan_mon.tic()
        mod.forward(batch, is_train=False)
        counts = [float(v) for _, _, v in nan_mon.toc()]
        anomalies.append((telemetry_count(
            mx, "run_anomalies_total", kind="nonfinite_tensor") - before,
            sum(c > 0 for c in counts)))
    row = {"allocated": torch.cuda.memory_allocated(),
           "reported": len(res), "want": len(want),
           "names_match": sorted(k for _, k, _ in res) == want,
           "worst_stat_rel": worst, "k5_launches": launched,
           "nan": {"clean": anomalies[0], "nan_batch": anomalies[1]}}
    print(json.dumps({"phase": "26e", **row}), flush=True)
    check(row["names_match"], "the monitor reported %d of %d conv outputs"
          % (len(res), len(want)))
    check(worst <= OBS_STAT_REL, "a bf16 stat is %.3g from its f32 "
          "recomputation" % worst)
    check(launched == K5_PER_STEP, "a monitored step launched K5 %d times"
          % launched)
    check(anomalies[0][0] == 0 and anomalies[1][0] > 0,
          "nonfinite anomalies clean %s, NaN batch %s" % tuple(anomalies))
    return row


def phase_obs_gluon(mx, counters, rng):
    """26f: the phase-19 Gluon loop (NHWC, bf16, batch 128, hybridized)
    for OBS_GLUON_STEPS steps under the Trainer's ImplicitStepper; U1 in
    each step's opt_update."""
    u1 = counters["multi_tensor_update"]
    ctx = mx.gpu(0)
    net = gluon_net(mx, ctx, "NHWC")
    net.cast("bfloat16")
    net.hybridize()
    trainer = gluon_trainer(mx, net)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x = mx.nd.array(rng.rand(*gluon_shape("NHWC", RESNET_BATCH))
                    .astype(np.float32), ctx=ctx, dtype="bfloat16")
    y = mx.nd.array(rng.randint(0, CLASSES, RESNET_BATCH)
                    .astype(np.float32), ctx=ctx)
    in_update = []
    impl = mx.gluon.Trainer._update_impl

    def spied(self):
        before = u1.launches
        impl(self)
        in_update.append(u1.launches - before)
    mx.gluon.Trainer._update_impl = spied
    try:
        mx.stepprof.reset()
        before = u1.launches
        for _ in range(OBS_GLUON_STEPS):
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(RESNET_BATCH)
        torch.cuda.synchronize()
    finally:
        mx.gluon.Trainer._update_impl = impl
    shares = mx.stepprof.shares()
    row = {"steps": mx.stepprof.profiler.step_stats()["steps"],
           "shares": shares, "shares_sum": sum(shares.values()),
           "u1_in_opt_update": in_update,
           "u1_launches": u1.launches - before}
    print(json.dumps({"phase": "26f", **row}), flush=True)
    check(row["steps"] == OBS_GLUON_STEPS and
          abs(row["shares_sum"] - 1) <= 0.01 and shares["opt_update"] > 0,
          "Gluon steps %d, shares %s" % (row["steps"], shares))
    check(in_update == [1] * OBS_GLUON_STEPS
          and row["u1_launches"] == OBS_GLUON_STEPS,
          "U1 in each opt_update %s, in all %d" % (in_update,
                                                   row["u1_launches"]))
    return row


def observability_telemetry_main():
    """26g's process (``MXNET_TELEMETRY_DIR`` and ``MXNET_THREADSAN=1``
    set by the caller): OBS_TELEMETRY_STEPS fit steps of 26a's Module,
    the witness's reports, then a deliberate lock-order inversion. Prints
    one JSON line."""
    import threading
    import mxnet_tpu_torch as mx
    os.environ["MXNET_CONV1X1_PALLAS"] = "1"
    mod = resnet_module(mx, mx.gpu(0), RESNET_BATCH, "bfloat16")
    batches = image_batches(mx, np.random.RandomState(SEED + 26),
                            mx.gpu(0), 2, RESNET_BATCH, "bfloat16")
    obs_fit(mx, mod, batches, OBS_TELEMETRY_STEPS)
    mx.telemetry.flush()

    def cycles():
        return sum(r["kind"] == "potential_deadlock"
                   for r in mx.threadsan.snapshot()["reports"])
    clean = cycles()
    a = mx.threadsan.register("smoke.A", threading.Lock())
    b = mx.threadsan.register("smoke.B", threading.Lock())
    for outer, inner in ((a, b), (b, a)):
        with outer:
            with inner:
                pass
    print(json.dumps({"armed": mx.threadsan.ARMED, "cycles_fit": clean,
                      "cycles_inverted": cycles(),
                      "locks": sorted(mx.threadsan.snapshot()["locks"]),
                      "swallowed": telemetry_count(
                          mx, "errors_swallowed_total")}), flush=True)
    return 0


def phase_obs_telemetry(mx, tmp):
    """26g: the telemetry subprocess's files, merged into one chrome
    trace with one step span set a step; the witness's reports."""
    out_dir = os.path.join(tmp, "telemetry")
    env = dict(os.environ, MXNET_TELEMETRY_DIR=out_dir, MXNET_THREADSAN="1")
    sub = run_own_process("--observability-telemetry", OBS_TIMEOUT_S,
                          env=env)
    files = sorted(os.listdir(out_dir))
    trace = mx.telemetry.merge(out_dir, out=os.path.join(tmp, "merged.json"))
    names = {}
    for ev in trace["traceEvents"]:
        names[ev["name"]] = names.get(ev["name"], 0) + 1
    phases = {n: c for n, c in names.items() if n.startswith("step.")}
    row = {"files": files, "steps": names.get("step", 0),
           "step_phases": phases, "subprocess": sub}
    print(json.dumps({"phase": "26g", **row}), flush=True)
    check(any(f.startswith("events_host") and f.endswith(".jsonl")
              for f in files) and any(f.endswith(".prom") for f in files),
          "the telemetry dir holds %s" % files)
    check(row["steps"] == OBS_TELEMETRY_STEPS and all(
        phases.get("step." + p, 0) >= OBS_TELEMETRY_STEPS
        for p in ("data_wait", "h2d", "dispatch", "opt_update",
                  "device_compute")),
          "the merged trace holds %d step spans and %s"
          % (row["steps"], phases))
    check(sub["armed"] and sub["cycles_fit"] == 0
          and sub["cycles_inverted"] == 1 and sub["swallowed"] == 0,
          "threadsan: %s" % sub)
    return row


def phase_obs_examples(mx, tmp):
    """26h: the slice's examples through run_example under gpu(0)."""
    from mxnet_tpu_torch.tools.run_example import run_example
    root = os.path.dirname(os.path.abspath(__file__))
    rows = []
    for rel, argv, line in OBS_EXAMPLES:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.chdir(tmp), contextlib.redirect_stdout(out):
            run_example(os.path.join(root, "examples", rel), argv, "gpu")
        lines = out.getvalue().splitlines()
        rows.append({"example": rel, "argv": argv,
                     "ok": any(line in ln for ln in lines),
                     "seconds": time.perf_counter() - t0})
    print(json.dumps({"phase": "26h", "examples": rows}), flush=True)
    check(all(r["ok"] for r in rows), "the examples: %s" % rows)
    return rows


def observability_main():
    """Phase 26 in a process of its own: 26a-26h on the ResNet-50 path
    (bf16, NHWC, batch 128, gate on), every kernel's count set to 0 first
    and read last; prints a JSON line a sub-phase, then one with the
    launches and the swallowed-error count."""
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["MXNET_CONV1X1_PALLAS"] = "1"
    card = nvidia_smi()
    ops = mx.ops
    counters = {"fused_lstm": ops.fused_lstm,
                "fused_lstm_train": ops.fused_lstm_train,
                "lstm_bwd_recurrence": ops.lstm_bwd_recurrence,
                "conv1x1_s2_dgrad": ops.conv1x1_s2_dgrad,
                "flash_attention": ops.flash_attention, "rtc": mx.rtc.Kernel,
                "multi_tensor_update": ops.multi_tensor_update,
                "greedy_nms": ops.greedy_nms,
                "sparse_row_update": ops.sparse_row_update}
    rng = np.random.RandomState(SEED + 26)
    t0 = time.perf_counter()
    mod = resnet_module(mx, mx.gpu(0), RESNET_BATCH, "bfloat16")
    batches = image_batches(mx, rng, mx.gpu(0), OBS_STAGED, RESNET_BATCH,
                            "bfloat16")
    swallowed = telemetry_count(mx, "errors_swallowed_total")
    for c in counters.values():               # the path starts here
        c.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        row_a = phase_obs_stack(mx, mod, batches, counters)
        k5_event = counters["conv1x1_s2_dgrad"].launches
        phase_obs_trace(mx, mod, batches, counters, tmp)
        timing = counters["conv1x1_s2_dgrad"].launches - k5_event - \
            K5_PER_STEP * OBS_TRACED_STEPS     # 26b's CUDA-event calls
        phase_obs_mfu(mx, mod, row_a, card)
        phase_obs_memory(mx, mod, batches, tmp)
        phase_obs_monitor(mx, mod, batches, counters)
        del mod, batches
        torch.cuda.empty_cache()
        phase_obs_gluon(mx, counters, rng)
        phase_obs_telemetry(mx, tmp)
        phase_obs_examples(mx, tmp)
    launches = launches_of(counters)          # ... and ends here
    launches["conv1x1_s2_dgrad"] -= timing    # not the main path
    swallowed = telemetry_count(mx, "errors_swallowed_total") - swallowed
    print(json.dumps({"phase": "26", "kernel_launches": launches,
                      "errors_swallowed": swallowed, "card": card,
                      "seconds": time.perf_counter() - t0}), flush=True)
    check(swallowed == 0, "%d errors were swallowed" % swallowed)
    check(launches["conv1x1_s2_dgrad"] > 0
          and launches["multi_tensor_update"] > 0
          and not any(n for k, n in launches.items()
                      if k not in ("conv1x1_s2_dgrad",
                                   "multi_tensor_update")),
          "the observability path launched %s: want K5 and U1 only"
          % launches)
    return 0


def phase_observability(mx):
    """Phase 26: ``observability_main`` in a process of its own (a fresh
    tracer, registry and ledger); its lines are logged, its launches
    returned."""
    t0 = time.perf_counter()
    last = run_own_process("--observability", OBS_TIMEOUT_S,
                           log_prefix="{", log_as="phase %s")
    log("phase 26 seconds %.1f" % (time.perf_counter() - t0))
    return last["kernel_launches"]


# ---------------------------------------------------------------------------
# phase 27: the serving stack
# ---------------------------------------------------------------------------
SERVING_REPLICAS = 2
# every completed request's reqtrace phases sum to its wall latency
TELESCOPE_ATOL = 1e-6
SLOW_REQUEST_S = 0.2
REQUESTS_AFTER_DEATH = 20
HTTP_REQUESTS = 6
# serve_bench on the LM: a closed loop of about this many seconds, then
# open loops at these fractions of its rate, as long each
SERVE_BENCH_CLIENTS, SERVE_BENCH_S, SERVE_BENCH_OPEN = 16, 5.0, (0.5, 0.9)
# the C client on device type 2 against the Predictor on gpu(0): the same
# graph, but the probabilities cross the C boundary as f32 bytes
C_CLIENT_BATCH, C_CLIENT_RTOL, C_CLIENT_ATOL = 4, 1e-4, 1e-5


def prom_value(text, name, **labels):
    """The sum of the Prometheus samples of ``name`` whose labels hold
    ``labels``."""
    total = 0.0
    for m in re.finditer(r"^%s(\{[^}]*\})? (\S+)$" % re.escape(name), text,
                         re.M):
        got = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1) or ""))
        if all(got.get(k) == v for k, v in labels.items()):
            total += float(m.group(2))
    return total


def http_call(port, path, doc=None, rid=None):
    """(status, headers, body bytes) of one request to a local server."""
    body = None if doc is None else json.dumps(doc).encode()
    headers = {"Content-Type": "application/json"}
    if rid:
        headers["X-Request-Id"] = rid
    req = urllib.request.Request("http://127.0.0.1:%d%s" % (port, path),
                                 data=body, headers=headers,
                                 method="GET" if doc is None else "POST")
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(req, timeout=300) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


def serving_engine(mx, sym_json, params, warmup=True, **cfg):
    cfg = dict(dict(max_batch_size=ENGINE_MAX_BATCH, max_batch_delay_ms=2.0,
                    max_queue=2 * ENGINE_REQUESTS,
                    replicas=SERVING_REPLICAS), **cfg)
    return mx.serving.InferenceEngine(
        sym_json, params, input_shapes={"data": (SEQ,)}, ctx=mx.gpu(0),
        config=mx.serving.EngineConfig(**cfg), warmup=warmup)


def phase_serving_compiles(mx, engine, ref, rng):
    """27a: warm-up captures, 100 requests from 16 clients with no capture
    under load, K1 twice a served batch, a profiled replay per bucket."""
    mem0 = torch.cuda.memory_allocated()
    engine.warm()
    torch.cuda.synchronize()
    pool_bytes = torch.cuda.memory_allocated() - mem0
    ledger = {sec: n for (scope, sec), n in mx.xla_stats.ledger().items()
              if scope == "executor.forward"}
    want = SERVING_REPLICAS * len(engine.buckets)
    check(engine.warmup_compiles == want and engine.cold_compiles() == 0,
          "warm() compiled %d signatures, want %d (replicas x buckets)"
          % (engine.warmup_compiles, want))
    graphs = [type(e).__name__ for rep in engine._replicas
              for e in rep.preds[1]._exec._program._cache.values()]
    check(graphs == ["_Graph"] * want, "the served forwards are %s, want "
          "%d captured graphs" % (graphs, want))
    mx.serving.reqtrace.reset()
    reqs = [tokens(rng, int(rng.randint(1, 9)))
            for _ in range(ENGINE_REQUESTS)]
    k1 = mx.ops.fused_lstm.launches

    def one(i):
        return engine.predict({"data": reqs[i]}, timeout=300,
                              rid="smoke-%d" % i)[0]

    t0 = time.perf_counter()
    with ThreadPoolExecutor(ENGINE_CLIENTS) as pool:
        outs = list(pool.map(one, range(ENGINE_REQUESTS)))
    wall = time.perf_counter() - t0
    k1 = mx.ops.fused_lstm.launches - k1
    # read before the CPU reference compiles its own predictors (the
    # compile count is the process's)
    cold = engine.cold_compiles()
    st = engine.stats()
    batches = sum(v["batches"] for v in st["padding"]["buckets"].values())
    check(cold == 0, "%d compiles under load: %s"
          % (cold, mx.compiled.last_retrace()))
    sample = range(0, ENGINE_REQUESTS, ENGINE_REQUESTS // 8)
    errs = [compare(outs[i], ref(reqs[i]), "served request %d" % i)
            for i in sample]
    check(k1 == LAYERS * batches, "K1 launched %d times in %d served "
          "batches, want %d (once a layer)" % (k1, batches,
                                               LAYERS * batches))
    profiles = {}
    for b, pred in sorted(engine._replicas[0].preds.items()):
        toks = tokens(rng, b)
        # the forward (input copy, replay, output clone) to a synchronize,
        # as phase 6 profiles it; the readback to the host apart
        prof = call_profile(lambda: pred.forward(data=toks))
        t0 = time.perf_counter()
        pred.get_output(0)
        readback = (time.perf_counter() - t0) * 1e3
        calls = prof["runtime_calls"]
        profiles[b] = {"wall_ms": prof["wall_ms"],
                       "device_busy_ms": prof["device_busy_ms"],
                       "device_idle_share": prof["device_idle_share"],
                       "readback_ms": readback,
                       "graph_launches": calls.get("cudaGraphLaunch"),
                       "kernel_launches": sum(
                           n for k, n in calls.items()
                           if "LaunchKernel" in k)}
        check(calls.get("cudaGraphLaunch") == 1
              and not any("LaunchKernel" in k for k in calls),
              "a served batch of bucket %d made host calls %s, want one "
              "cudaGraphLaunch and no kernel launch" % (b, calls))
    return {"warmup_compiles": engine.warmup_compiles,
            "warmup_s": engine.warmup_seconds,
            "graph_pool_bytes_two_replicas": pool_bytes,
            "ledger_last_capture": ledger,
            "requests": ENGINE_REQUESTS, "clients": ENGINE_CLIENTS,
            "wall_s": wall, "requests_per_s": ENGINE_REQUESTS / wall,
            "batches": batches, "k1_launches": k1, "cold_compiles": cold,
            "sampled": len(errs),
            "max_abs_err_vs_cpu": max(errs), "rtol": SERVE_RTOL,
            "atol": SERVE_ATOL, "forward_by_bucket": profiles}


def phase_serving_anatomy(mx):
    """27b: the reqtrace phases of every completed request telescope."""
    rt = mx.serving.reqtrace
    recs = rt.tracer.records()
    worst = max(abs(sum(r["phases"].values()) - r["total"]) for r in recs)
    att = rt.tracer.attribution()
    verdict, _ = rt.classify(att["p99_shares"],
                             shed_fraction=att["shed_fraction"],
                             pad_waste=att["pad"].get("waste_ratio"))
    check(len(recs) == ENGINE_REQUESTS and worst <= TELESCOPE_ATOL
          and all(set(r["phases"]) == set(rt.PHASES) for r in recs),
          "%d traces, phases off their wall latency by up to %.3g s"
          % (len(recs), worst))
    return {"traces": len(recs), "worst_telescope_error_s": worst,
            "latency_s": att["latency"], "p50_shares": att["p50_shares"],
            "p99_shares": att["p99_shares"], "pad": att["pad"],
            "verdict": verdict}


def phase_serving_http(mx, engine, ref, rng):
    """27c: /predict with and without X-Request-Id, /metrics, /healthz,
    an unknown route."""
    server = mx.serving.serve(engine, port=0)
    try:
        echoed, served = [], []
        for i in range(HTTP_REQUESTS):
            toks = tokens(rng, 1 + i % 3)
            rid = "smoke-http-%d" % i if i else None
            code, headers, body = http_call(
                server.port, "/predict", {"inputs": {"data": toks.tolist()}},
                rid=rid)
            check(code == 200, "/predict answered %d" % code)
            served.append((toks, np.asarray(json.loads(body)["outputs"][0],
                                            np.float32)))
            echoed.append(headers.get("X-Request-Id"))
        code, headers, body = http_call(server.port, "/nope", rid="lost-1")
        missing = (code, headers.get("X-Request-Id"),
                   json.loads(body).get("request_id"))
        code, _, text = http_call(server.port, "/metrics")
        text = text.decode()
        code_h, _, health = http_call(server.port, "/healthz")
        health = json.loads(health)
    finally:
        server.shutdown()
        server.server_close()
    for toks, out in served:      # after /healthz read cold_compiles
        compare(out, ref(toks), "/predict output")
    st = engine.stats()
    batches = sum(v["batches"] for v in st["padding"]["buckets"].values())
    ok = prom_value(text, "serving_requests_total", status="ok")
    sent = ENGINE_REQUESTS + HTTP_REQUESTS
    row = {"ok_requests_in_metrics": ok, "requests_sent": sent,
           "batches_in_metrics": prom_value(text, "serving_batches_total"),
           "batches_in_stats": batches, "echoed_ids": echoed,
           "unknown_route": missing, "healthz": {
               k: health.get(k) for k in (
                   "status", "cold_compiles", "warmup_compiles",
                   "headroom_bytes", "peak_fraction", "queue_depth",
                   "pending", "workers_alive", "slo")}}
    check(code == 200 and ok == sent
          and row["batches_in_metrics"] == batches,
          "/metrics counts %s" % row)
    check(re.fullmatch(r"[0-9a-f]{16}", echoed[0] or "") is not None
          and echoed[1:] == ["smoke-http-%d" % i
                             for i in range(1, HTTP_REQUESTS)],
          "X-Request-Id echoed as %s" % echoed)
    check(missing == (404, "lost-1", "lost-1"), "an unknown route answered "
          "%s" % (missing,))
    check(code_h == 200 and health["cold_compiles"] == 0
          and isinstance(health.get("headroom_bytes"), int),
          "/healthz answered %d %s" % (code_h, row["healthz"]))
    return row


def phase_serving_chaos(mx, engine, tmp):
    """27d: one worker death fails only its batch and respawns; a slow
    request's stall lands in batch_wait."""
    os.environ["MXNET_TELEMETRY_DIR"] = tmp
    try:
        deaths = telemetry_count(mx, "serving_worker_deaths_total",
                                 replica="0") + telemetry_count(
            mx, "serving_worker_deaths_total", replica="1")
        errors = telemetry_count(mx, "serving_requests_total",
                                 status="error")
        mx.chaos.arm("serving.worker_death")
        died = None
        try:
            engine.predict({"data": tokens(np.random.RandomState(0), 3)},
                           timeout=300, rid="smoke-death")
        except mx.MXNetError as exc:
            died = str(exc)
        ok = 0
        for i in range(REQUESTS_AFTER_DEATH):
            out = engine.predict({"data": tokens(np.random.RandomState(i),
                                                 1 + i % 4)}, timeout=300)[0]
            ok += out.shape == (1 + i % 4, SEQ, VOCAB)
        deaths = telemetry_count(mx, "serving_worker_deaths_total",
                                 replica="0") + telemetry_count(
            mx, "serving_worker_deaths_total", replica="1") - deaths
        respawns = telemetry_count(mx, "serving_worker_respawns_total")
        errors = telemetry_count(mx, "serving_requests_total",
                                 status="error") - errors
        # the death's own post-mortem, after the requests that follow it
        # (a leak-sentinel trip among them writes the newest dump,
        # flightrecorder-host<h>.json, under its own reason)
        dump = mx.xla_stats.reason_dump_path(tmp, "serving.worker_death")
        reason = json.load(open(dump))["reason"] if os.path.exists(dump) \
            else None
    finally:
        os.environ.pop("MXNET_TELEMETRY_DIR", None)
        mx.chaos.clear()
    row = {"failed_request": died, "deaths": deaths, "respawns": respawns,
           "error_requests": errors, "ok_after": ok,
           "workers_alive": engine.stats()["workers_alive"],
           "flight_recorder_reason": reason,
           "cold_compiles": engine.cold_compiles()}
    check(died is not None and "worker died" in died and deaths == 1
          and respawns == 1 and errors == 1
          and ok == REQUESTS_AFTER_DEATH
          and row["workers_alive"] == SERVING_REPLICAS
          and reason == "serving.worker_death"
          and row["cold_compiles"] == 0,
          "a worker death: %s" % row)
    mx.serving.reqtrace.reset()
    with mx.chaos.armed("serving.slow_request", value=str(SLOW_REQUEST_S)):
        engine.predict({"data": tokens(np.random.RandomState(1), 2)},
                       timeout=300)
    rec, = mx.serving.reqtrace.tracer.records()
    row["slow_request_phases"] = rec["phases"]
    check(rec["phases"]["batch_wait"] >= SLOW_REQUEST_S
          and max(rec["phases"], key=rec["phases"].get) == "batch_wait",
          "the %.1f s stall landed in %s" % (SLOW_REQUEST_S, rec["phases"]))
    return row


def phase_serving_admission(mx, sym_json, params):
    """27e: a projection above the card's free memory is refused before
    any replica binds."""
    free, total = torch.cuda.mem_get_info()
    per_replica = mx.xla_stats.tree_shard_bytes(params)
    replicas = int(total // per_replica) + 1
    mem0 = torch.cuda.memory_allocated()
    compiles = mx.compiled.compile_counts()["compiles"]
    refused = None
    try:
        mx.serving.InferenceEngine(sym_json, params,
                                   input_shapes={"data": (SEQ,)},
                                   ctx=[mx.gpu(0)] * replicas)
    except mx.memprof.MemoryAdmissionError as exc:
        refused = exc.decision
    row = {"replicas": replicas, "projected_bytes": per_replica * replicas,
           "free_bytes": free, "decision": refused,
           "allocated_delta": torch.cuda.memory_allocated() - mem0,
           "compiles": mx.compiled.compile_counts()["compiles"] - compiles}
    check(refused is not None and not refused["admitted"]
          and row["projected_bytes"] > free and row["allocated_delta"] == 0
          and row["compiles"] == 0,
          "admission of %d replicas: %s" % (replicas, row))
    return row


def phase_serving_bench(mx, sym_json, params, rate):
    """27f: tools/serve_bench.py on the LM: a closed loop of 16 clients,
    then open loops at fractions of its rate."""
    from mxnet_tpu_torch.tools import serve_bench

    def factory():
        return serving_engine(mx, sym_json, params), "data", (SEQ,)

    per_client = max(10, int(np.ceil(SERVE_BENCH_S * rate
                                     / SERVE_BENCH_CLIENTS)))
    runs = {"closed": serve_bench.bench_records(
        clients=SERVE_BENCH_CLIENTS, requests_per_client=per_client,
        mode="closed", engine_factory=factory)}
    closed = {r["metric"]: r for r in runs["closed"]}
    rps = closed["serving_closed_rps"]["value"]
    for frac in SERVE_BENCH_OPEN:
        runs["open %.1f" % frac] = serve_bench.bench_records(
            qps=frac * rps, seconds=SERVE_BENCH_S, mode="open",
            engine_factory=factory)
    rows = {}
    for key, recs in runs.items():
        mode = key.split()[0]
        by = {r["metric"]: r for r in recs}
        rows[key] = {q: by["serving_%s_%s" % (mode, q)]["value"]
                     for q in ("rps", "rows_per_sec", "p50_ms", "p95_ms",
                               "p99_ms")}
        rows[key].update(
            verdict=by["serving_%s_p99_ms" % mode].get("verdict"),
            p99_phases=by["serving_%s_p99_ms" % mode].get("phases"),
            cold_compiles=by["serving_cold_compiles"]["value"],
            warmup_compiles=by["serving_warmup_compiles"]["value"],
            failed={m: r["value"] for m, r in by.items()
                    if m.endswith("_total")})
        log("phase 27f serve_bench %s %s" % (key, json.dumps(rows[key])))
        check(all(np.isfinite(rows[key][q]) and rows[key][q] > 0
                  for q in ("rps", "p50_ms", "p95_ms", "p99_ms"))
              and rows[key]["cold_compiles"] == 0,
              "serve_bench %s read %s" % (key, rows[key]))
    rows["requests_per_client_closed"] = per_client
    return rows


def phase_serving_c_abi(mx, sym_json, params, tmp):
    """27g: the MXPred* C client on device type 2 against the Python
    Predictor on gpu(0), and its bad-argument exit (its failed calls,
    which end in MXGetLastError's message, are held on the CPU by
    tests/test_torch_c_predict.py)."""
    from mxnet_tpu_torch import native
    t0 = time.perf_counter()
    client = native.predict_client()
    build_s = time.perf_counter() - t0
    sym_path = os.path.join(tmp, "lm-symbol.json")
    par_path = os.path.join(tmp, "lm.params")
    with open(sym_path, "w") as fh:
        fh.write(sym_json)
    mx.nd.save(par_path, params)
    toks = tokens(np.random.RandomState(27), C_CLIENT_BATCH)
    pred = mx.Predictor(sym_json, params, ctx=mx.gpu(0),
                        input_shapes={"data": toks.shape})
    pred.forward(data=toks)
    want = pred.get_output(0)

    def run(*args):
        return subprocess.run([str(client), sym_path, par_path] + list(args),
                              input=toks.tobytes(), capture_output=True,
                              env=native.client_env(), timeout=300)

    t0 = time.perf_counter()
    out = run("data", "2", str(C_CLIENT_BATCH), str(SEQ))
    client_s = time.perf_counter() - t0
    check(out.returncode == 0, "the C client exited %d: %s"
          % (out.returncode, out.stderr.decode()[-2000:]))
    got = np.frombuffer(out.stdout, np.float32)
    check(got.size == want.size, "the C client wrote %d values, want %d"
          % (got.size, want.size))
    got = got.reshape(want.shape)
    err = float(np.abs(got - want).max())
    check(np.allclose(got, want, rtol=C_CLIENT_RTOL, atol=C_CLIENT_ATOL),
          "the C client's output differs from the Predictor's by %.3g" % err)
    bad = run("data", "3", str(C_CLIENT_BATCH), str(SEQ))
    row = {"build_s": build_s, "client_s": client_s, "max_abs_err": err,
           "rtol": C_CLIENT_RTOL, "atol": C_CLIENT_ATOL,
           "bad_argument_exit": bad.returncode,
           "bad_argument_message": bad.stderr.decode()[-300:]}
    check(bad.returncode == 2 and "bad device type" in
          row["bad_argument_message"],
          "the C client's bad-argument exit: %s" % row)
    return row


def phase_serving(mx, sym_json, host, ref, card):
    """Phase 27 (run by ``serving_main``): the serving stack at the LM's
    full width on gpu(0), every hook of the JAX engine on (see the module
    docstring); returns K1's launches and the phase's rows."""
    t_phase = time.perf_counter()
    rng = np.random.RandomState(SEED + 27)
    mx.telemetry.reset()          # /metrics counts from here
    params = mx.params_from_numpy(host, mx.cpu())
    counters = {"fused_lstm": mx.ops.fused_lstm,
                "fused_lstm_train": mx.ops.fused_lstm_train,
                "lstm_bwd_recurrence": mx.ops.lstm_bwd_recurrence,
                "conv1x1_s2_dgrad": mx.ops.conv1x1_s2_dgrad,
                "flash_attention": mx.ops.flash_attention,
                "rtc": mx.rtc.Kernel,
                "multi_tensor_update": mx.ops.multi_tensor_update,
                "greedy_nms": mx.ops.greedy_nms,
                "sparse_row_update": mx.ops.sparse_row_update}
    for c in counters.values():           # the serving path starts here
        c.launches = 0
    rows = {"card": card}
    # the CPU reference compiles its predictors (every request size of
    # the phase) before the engine warms: the compile count is the
    # process's, and nothing else may compile while the engine serves
    for n in range(1, 9):
        ref(tokens(rng, n))
    engine = serving_engine(mx, sym_json, params, warmup=False)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            rows["a"] = phase_serving_compiles(mx, engine, ref, rng)
            log("phase 27a compiles %s" % json.dumps(rows["a"]))
            rows["b"] = phase_serving_anatomy(mx)
            log("phase 27b anatomy %s" % json.dumps(rows["b"]))
            rows["c"] = phase_serving_http(mx, engine, ref, rng)
            log("phase 27c http %s" % json.dumps(rows["c"]))
            rows["d"] = phase_serving_chaos(mx, engine, tmp)
            log("phase 27d chaos %s" % json.dumps(rows["d"]))
        finally:
            engine.shutdown()
        del engine
        torch.cuda.empty_cache()
        rows["e"] = phase_serving_admission(mx, sym_json, params)
        log("phase 27e admission %s" % json.dumps(rows["e"]))
        rows["f"] = phase_serving_bench(mx, sym_json, params,
                                        rows["a"]["requests_per_s"])
        rows["g"] = phase_serving_c_abi(mx, sym_json, params, tmp)
        log("phase 27g C ABI %s" % json.dumps(rows["g"]))
    launches = {k: c.launches for k, c in counters.items()}  # ... ends here
    swallowed = telemetry_count(mx, "errors_swallowed_total")
    log("phase 27 serving %s" % json.dumps({
        "kernel_launches": launches, "errors_swallowed": swallowed,
        "card": card, "seconds": time.perf_counter() - t_phase}))
    check(launches["fused_lstm"] > 0
          and not any(n for k, n in launches.items() if k != "fused_lstm"),
          "the serving path launched %s: want K1 only" % launches)
    check(swallowed == 0, "%d errors swallowed across phase 27" % swallowed)
    return launches["fused_lstm"], rows


SERVING_TIMEOUT_S = 600


def serving_main():
    """Phase 27 in a process of its own (a fresh tracer, registry and
    allocator: late in the whole script the profiler's traces lose device
    events, PERF.md §7); prints its lines, then one JSON line with K1's
    launches."""
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    sym_json = lm_symbol(mx).tojson()
    host = lm_params(lm_symbol(mx), SEED)
    ref = Reference(mx, sym_json, mx.params_from_numpy(host, mx.cpu()))
    launches, _ = phase_serving(mx, sym_json, host, ref, card)
    print(json.dumps({"phase": "27", "fused_lstm_launches": launches}),
          flush=True)
    return 0


def phase_serving_process():
    """Phase 27: ``serving_main`` in a process of its own; its lines are
    logged, K1's launches returned."""
    t0 = time.perf_counter()
    last = run_own_process("--serving", SERVING_TIMEOUT_S,
                           log_prefix="phase 27")
    log("phase 27 seconds %.1f" % (time.perf_counter() - t0))
    return last["fused_lstm_launches"]


# ---------------------------------------------------------------------------
# phase 28: the breadth slice (`python3 chip_smoke.py --breadth`): Adam with
# multi_precision through U1's mp_adam, the model zoo served and trained,
# linalg, the compat ops, the file iterators, callbacks and FeedForward
# ---------------------------------------------------------------------------
BREADTH_TIMEOUT_S = 600
# (b)'s Adam of phase 21 with an f32 master copy of each bf16 weight, in
# the image bench's configuration (NHWC, bf16, batch 128, the gate on); its
# card-vs-CPU check at phase 21's Adam check lr
MP_ADAM_OPT = dict(OPT_B, multi_precision=True)
MP_ADAM_CHECK_OPT = dict(MP_ADAM_OPT, learning_rate=OPT_B_CHECK[
    "learning_rate"])
# each zoo family's flagship served hybridized (f32, NCHW, TF32 off) at
# batch 32 after its one capture, against eager on the card and on cpu()
# at batch 2 (INFER_REL, phase 18's limit)
ZOO_SERVED = (("alexnet", 224), ("vgg16", 224), ("squeezenet1.1", 224),
              ("mobilenet1.0", 224), ("mobilenetv2_1.0", 224),
              ("densenet121", 224), ("inceptionv3", 299))
ZOO_BATCH, ZOO_CHECK_BATCH, ZOO_REPLAYS = 32, 2, 20
# two families trained through phase 19's Gluon loop, f32 NCHW batch 32,
# SGD momentum 0.9; their card-vs-CPU check at batch 4 on ZOO_CHECK_SEEDS
# seeds (weights and data), each parameter's gradient and update by
# relative norm. At batch 4 these gradients are ill-conditioned: a
# training-mode BatchNorm's f32 statistics (E[x^2] - mean^2, as in the
# JAX package), ReLU's and ReLU6's kinks and the sums' order turn f32
# rounding into leaf errors of 0.03-0.33 (H100, 700 W). The check prints
# a floor of that amplification: the CPU against itself with each input
# value moved one unit in the last place, which read a quarter to a third
# of the card-vs-CPU medians on every net and seed. The median leaf is
# held to GRAD_REL (sound medians at most 0.149; the controls, a
# label-shifted step and an update without momentum, at least 0.667),
# the worst leaf to ZOO_GRAD_REL (sound at most 0.331), about the
# geometric mean of 0.331 and the 1.0 of a leaf whose gradient is lost.
ZOO_TRAINED = (("inceptionv3", 299), ("mobilenetv2_1.0", 224))
ZOO_CHECK_SEEDS = 3
ZOO_GRAD_REL = 0.6
ZOO_OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
ZOO_CHECK_OPT = dict(ZOO_OPT, learning_rate=GLUON_CHECK_OPT["learning_rate"])
# linalg on the card against cpu(): batches of 64 of 128 x 128 f32
# matrices (gelqf 128 x 256), the largest difference over the largest
# magnitude of the CPU's value, forward and input gradients; the control
# (the inputs rounded to bf16 on the card) must fail LINALG_REL
LINALG_BATCH, LINALG_N = 64, 128
LINALG_REL = 1e-4
# syevd's eigenvectors carry eps * |A| / gap of error: with eigenvalues
# 1..128 one apart, about 1e-5 of entries near 0.09, which two
# eigensolvers (cuSOLVER's, LAPACK's) place differently; on an H100 at
# 700 W its sound readings were 2.2e-4 (rows squared) and 1.5e-4
# (gradient), its control 0.047: the limit is about their geometric mean
LINALG_LIMITS = {"syevd": 3e-3}
# the negative-binomial samplers' draws a parameter on the card
NB_DRAWS = 1 << 20
BREADTH_FIT_EPOCHS = 2
MNIST_ARGS = ["--ctx", "tpu", "--num-epochs", "2", "--num-examples", "600",
              "--batch-size", "50"]


def host_states(mx, states):
    """An updater's states copied onto cpu(), tuples kept."""
    if isinstance(states, tuple):
        return tuple(host_states(mx, s) for s in states)
    if states is None:
        return None
    return mx.nd.array(states.asnumpy(), ctx=mx.cpu(), dtype=states.dtype)


def phase_mp_adam_check(mx, rng):
    """Phase 28b, part 2: 2 steps at batch 4 of the bf16 NHWC ResNet-50
    with ``Adam(multi_precision=True)`` on gpu(0) and on cpu(), the gate
    on. Before each step the CPU net takes the card's weights, and the
    CPU Trainer steps from the card's gradients and optimizer states
    (phase 21's rule for Adam): each parameter's master update, mean and
    var by relative norm to GRAD_REL, and every bf16 weight the rounding
    of its master on both sides. The control, a third step whose update
    on the card skips the bias correction, must fail GRAD_REL. Returns
    the readings and the U1 launches of the card's steps."""
    from mxnet_tpu_torch.ops.multi_tensor import multi_tensor_update
    shape = gluon_shape("NHWC", GLUON_CHECK_BATCH)
    card = gluon_net(mx, mx.gpu(0), "NHWC")
    card(mx.nd.zeros(shape, ctx=mx.gpu(0)))
    card.cast("bfloat16")
    card.hybridize()
    host = gluon_net(mx, mx.cpu(), "NHWC", prefix=card.prefix)
    host.cast("bfloat16")
    mx.set_block_params(host, gluon_values(card))
    trainers = [gluon_trainer(mx, n, MP_ADAM_CHECK_OPT, "adam")
                for n in (card, host)]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    names = [p.name for p in trainers[0]._params]

    def states(t):
        """{name: (master, mean, var)} as f32 numpy."""
        return {names[i]: (m.asnumpy(), mean.asnumpy(), var.asnumpy())
                for i, (m, (mean, var)) in t._updaters[0].states.items()}

    def card_step(correct=True):
        x = mx.nd.array(rng.rand(*shape).astype(np.float32), ctx=mx.gpu(0),
                        dtype="bfloat16")
        y = mx.nd.array(rng.randint(0, CLASSES, GLUON_CHECK_BATCH).astype(
            np.float32), ctx=mx.gpu(0))
        mx.set_block_params(host, gluon_values(card))
        gluon_record(mx, card, loss_fn, x, y)
        host_params = host.collect_params()
        for n, p in card.collect_params().items():
            if p.grad_req != "null":
                host_params[n].grad()[:] = p.grad().asnumpy()
        src, dst = (t._updaters[0] for t in trainers)
        if src.states:
            dst.states = {i: host_states(mx, st)
                          for i, st in src.states.items()}
            dst.states_synced = dict.fromkeys(dst.states, True)
        # the masters before the step: a first step makes them from the
        # bf16 weights
        before = states(trainers[0]) if src.states else {
            n: (v,) for n, v in gluon_values(card).items()}
        adam = trainers[0]._optimizer
        if not correct:
            adam._corrected_lr = lambda index, lr: lr
        try:
            trainers[0].step(GLUON_CHECK_BATCH)
        finally:
            if not correct:
                del adam._corrected_lr
        trainers[1].step(GLUON_CHECK_BATCH)
        got, want = states(trainers[0]), states(trainers[1])
        row = {k: leaf_errs({n: v[j] - (before[n][0] if j == 0 else 0)
                             for n, v in got.items()},
                            {n: v[j] - (before[n][0] if j == 0 else 0)
                             for n, v in want.items()})
               for j, k in enumerate(("master_update_rel", "mean_rel",
                                      "var_rel"))}
        rounded = []
        for net, st in ((card, got), (host, want)):
            params = net.collect_params()
            rounded.append(all(np.array_equal(
                params[n].data().asnumpy(),
                mx.nd.array(v[0], ctx=mx.cpu(), dtype="bfloat16")
                .asnumpy()) for n, v in st.items()))
        row["weights_are_masters_rounded"] = rounded
        return row

    u1_0 = multi_tensor_update.launches
    steps = [card_step() for _ in range(2)]
    control = card_step(correct=False)
    launches = multi_tensor_update.launches - u1_0
    summary = {"batch": GLUON_CHECK_BATCH, "opt": MP_ADAM_CHECK_OPT,
               "grad_rel_limit": GRAD_REL, "steps": steps,
               "control_adam_without_bias_correction": control,
               "u1_launches": launches}
    log("phase 28b mp_adam card vs cpu %s" % json.dumps(summary))
    fails = ["step %d %s of %s: %.3g" % (k, key, row[key]["worst"],
                                        row[key]["max"])
             for k, row in enumerate(steps)
             for key in ("master_update_rel", "mean_rel", "var_rel")
             if not row[key]["max"] <= GRAD_REL]
    fails += ["step %d: a weight is not its master rounded" % k
              for k, row in enumerate(steps + [control])
              if not all(row["weights_are_masters_rounded"])]
    if control["master_update_rel"]["max"] <= GRAD_REL:
        fails.append("the control passes the limit: %.3g"
                     % control["master_update_rel"]["max"])
    check(launches == 3, "the card's 3 Trainer steps launched U1 %d times"
          % launches)
    check(not fails, "mp_adam card vs cpu: " + "; ".join(fails))
    del card, host, trainers
    return summary


def phase_mp_adam_resnet(mx, rng):
    """Phase 28b: ResNet-50 v1 through Gluon with
    ``Adam(multi_precision=True)`` in the image bench's configuration
    (NHWC, bf16, batch 128, the gate on): phase 19's loop (2 warm-up and
    10 timed steps on one fixed batch, the loss falling), every weight's
    formula ``mp_adam``, U1 exactly once and K5 exactly 6 times a step;
    one profiled step; then the card-vs-CPU check."""
    from mxnet_tpu_torch.ops.multi_tensor import multi_tensor_update
    os.environ["MXNET_CONV1X1_PALLAS"] = "1"
    k5 = mx.ops.conv1x1_s2_dgrad
    u1_0, k5_0 = multi_tensor_update.launches, k5.launches
    u1_start = u1_0
    net, step, row = gluon_loop(mx, "NHWC", "bfloat16", GLUON_BF16_BATCH,
                                rng, opt_name="adam", opt=MP_ADAM_OPT)
    steps = GLUON_WARMUP + GLUON_STEPS
    fused = step.trainer._fused
    formulas = sorted({fused.formula(step.trainer._params[i].data(), st)
                       for i, st in fused.updater.states.items()})
    row.update(u1_launches=multi_tensor_update.launches - u1_0,
               k5_launches=k5.launches - k5_0, formulas=formulas)
    check(formulas == ["mp_adam"], "the bf16 net's Adam formulas %s, want "
          "mp_adam only" % formulas)
    check(row["u1_launches"] == steps and row["k5_launches"]
          == K5_PER_STEP * steps,
          "%d steps launched U1 %d and K5 %d times, want 1 and %d a step"
          % (steps, row["u1_launches"], row["k5_launches"], K5_PER_STEP))
    with ranged_ops([(step.trainer, "_update")]):
        prof = profiled_step(step)
    u1 = prof["classes"].get("U1 multi_tensor_update",
                             {"launches": 0, "ms": 0.0})
    k5p = prof["classes"].get("K5 conv1x1_s2_dgrad",
                              {"launches": 0, "ms": 0.0})
    row["profile"] = {
        "step_wall_ms": prof["step_wall_ms"],
        "device_busy_ms": prof["device_busy_ms"],
        "device_idle_share": prof["device_idle_share"],
        "u1": {"launches": u1["launches"], "ms": u1["ms"]},
        "k5": {"launches": k5p["launches"], "ms": k5p["ms"]},
        "update_host_ms": prof["update_host_ms"],
        "classes": {k: {"launches": v["launches"], "ms": v["ms"]}
                    for k, v in prof["classes"].items()}}
    log("phase 28b resnet50 mp_adam loop %s" % json.dumps(row))
    check(u1["launches"] == 1 and k5p["launches"] == K5_PER_STEP,
          "the profiled step shows U1 %d and K5 %d launches, want 1 and %d"
          % (u1["launches"], k5p["launches"], K5_PER_STEP))
    del net, step
    torch.cuda.empty_cache()
    check_row = phase_mp_adam_check(mx, rng)
    torch.cuda.empty_cache()
    # every U1 launch of this phase is mp_adam's: one bf16 group
    return {"loop": row, "check": check_row,
            "mp_adam_launches": multi_tensor_update.launches - u1_start}


def zoo_net(mx, name, ctx, **extra):
    from mxnet_tpu_torch.gluon.model_zoo import vision
    net = vision.get_model(name, **extra)
    net.initialize(mx.init.Xavier(magnitude=2), ctx=ctx)
    return net


def phase_zoo_serve(mx, rng, card):
    """Phase 28c: each family's flagship served as the bench serves
    ResNet-50 (f32, NCHW, TF32 off, batch 32): one compile, then
    ZOO_REPLAYS cache hits; one call under the profiler, one
    ``cudaGraphLaunch`` and no kernel launch; img/s over the replays,
    bracketed by ``synchronize``; the hybridized logits against the eager
    call on the card and against the eager net on cpu() at batch 2 from
    the same weights, by relative norm to INFER_REL."""
    from mxnet_tpu_torch import compiled
    rows, fails = {}, []
    for name, size in ZOO_SERVED:
        t0 = time.perf_counter()
        ctx = mx.gpu(0)
        net = zoo_net(mx, name, ctx)
        x = mx.nd.array(rng.rand(ZOO_BATCH, 3, size, size).astype(
            np.float32), ctx=ctx)
        eager = net(x).asnumpy()                # finishes deferred init
        net.hybridize()
        before = compiled.compile_counts()
        hybrid = net(x).asnumpy()
        first = compiled.compile_counts()
        for _ in range(ZOO_REPLAYS):
            out = net(x)
        timed = compiled.compile_counts()
        counts = {"first_call": {k: first[k] - before[k] for k in first},
                  "replays": {k: timed[k] - first[k] for k in timed}}
        prof = call_profile(lambda: net(x))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(ZOO_REPLAYS):
            out = net(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        host = zoo_net(mx, name, mx.cpu(), prefix=net.prefix)
        mx.set_block_params(host, gluon_values(net))
        on_cpu = host(mx.nd.array(x.asnumpy()[:ZOO_CHECK_BATCH],
                                  ctx=mx.cpu())).asnumpy()
        row = {"size": size, "batch": ZOO_BATCH,
               "imgs_per_s": ZOO_REPLAYS * ZOO_BATCH / wall,
               "call_ms": wall * 1e3 / ZOO_REPLAYS,
               "macs_per_image": resnet_macs(net, (1, 3, size, size)),
               "vs_eager_on_card": rel_err(hybrid, eager),
               "vs_eager_on_cpu": rel_err(hybrid[:ZOO_CHECK_BATCH], on_cpu),
               "replay_equal": bool(np.array_equal(out.asnumpy(), hybrid)),
               "compile_counts": counts,
               "profile": {k: prof[k] for k in (
                   "wall_ms", "device_busy_ms", "device_idle_share",
                   "runtime_calls", "top")},
               "card": card, "seconds": time.perf_counter() - t0}
        log("phase 28c %s served %s" % (name, json.dumps(row)))
        rows[name] = row
        if counts != {"first_call": {"compiles": 1, "cache_hits": 0,
                                     "retraces": 0, "uncaptured": 0},
                      "replays": {"compiles": 0, "cache_hits": ZOO_REPLAYS,
                                  "retraces": 0, "uncaptured": 0}}:
            fails.append("%s compile counts %s" % (name, counts))
        calls = prof["runtime_calls"]
        if calls.get("cudaGraphLaunch") != 1 or any(
                "LaunchKernel" in k for k in calls):
            fails.append("%s: a served call made host calls %s" % (name,
                                                                  calls))
        if not (bool(np.isfinite(hybrid).all()) and row["replay_equal"]
                and row["vs_eager_on_card"] <= INFER_REL
                and row["vs_eager_on_cpu"] <= INFER_REL):
            fails.append("%s logits: %s" % (name, {k: row[k] for k in (
                "replay_equal", "vs_eager_on_card", "vs_eager_on_cpu")}))
        del net, host, x
        torch.cuda.empty_cache()
    check(not fails, "the zoo served (limit %.3g): %s" % (INFER_REL,
                                                          "; ".join(fails)))
    return rows


def without_dropout(mx, block):
    """Every Dropout of ``block`` at rate 0: the card and the CPU draw
    different masks, so a card-vs-CPU check keeps none."""
    for child in block._children.values():
        if isinstance(child, mx.gluon.nn.Dropout):
            child._rate = 0.0
        without_dropout(mx, child)


def rounding_level(got, want, suffix, partner, scale=lambda v: v):
    """Split off the entries of ``want`` ending in ``suffix`` whose exact
    value is 0 and whose computed value is rounding: those whose norm is
    below BIAS_NOISE of their partner's (the same name ending in
    ``partner``, through ``scale``) on the CPU's side. They are removed
    from both dicts; returns {name: the larger ratio of the two sides}.
    A BatchNorm's beta whose output reaches the loss only through a
    convolution into another training-mode BatchNorm, which subtracts the
    batch mean, has gradient 0; that second BatchNorm's moving mean then
    tracks a batch mean of 0 (MobileNet v2's linear bottlenecks)."""
    out = {}
    for n in [n for n in want if n.endswith(suffix)]:
        ref = n[:-len(suffix)] + partner
        if ref not in want:
            continue
        ratios = [float(np.linalg.norm(d[n])
                        / (np.linalg.norm(scale(d[ref])) or 1.0))
                  for d in (want, got)]
        if ratios[0] < BIAS_NOISE:
            out[n] = max(ratios)
            del got[n], want[n]
    return out


def noise_summary(noise):
    if not noise:
        return {"count": 0}
    worst = max(noise, key=noise.get)
    return {"count": len(noise), "max": noise[worst], "worst": worst}


def phase_zoo_check(mx, name, size, seed):
    """Phase 28d's check on one seed of weights and data: 2 f32 steps at
    batch 4 (NCHW, TF32 off, SGD momentum 0.9 at lr 0.005, no dropout) of
    ``name`` on gpu(0) against cpu(), each from the card's weights, held
    as phase 19 holds ResNet-50: output probabilities and losses
    elementwise to RESNET_RTOL/ATOL; each step's gradients and updates by
    their median leaf's relative norm to GRAD_REL and their worst leaf's
    to ZOO_GRAD_REL; the gradients (and so the updates) and moving means
    whose exact value is 0, split off by ``rounding_level``, instead below
    BIAS_NOISE of their partners' on both sides, as phase 19 holds conv
    biases; the other moving statistics by relative norm to RESNET_RTOL
    (Inception's late moving means lie near 0 beside activations in the
    hundreds, so an elementwise tolerance reads the rounding of their
    sums: 7e-5 to 8e-5 apart on an H100 at 700 W). The rounding floor:
    the CPU's step-0 gradients from the input moved one ulp against its
    own. Controls whose median leaf must fail GRAD_REL: the card's
    gradients from the batch's labels shifted by one class; the second
    update without its momentum term. Returns (summary, fails)."""
    mx.random.seed(seed)
    rng = np.random.RandomState(seed)
    shape = (GLUON_CHECK_BATCH, 3, size, size)
    card = zoo_net(mx, name, mx.gpu(0))
    card(mx.nd.zeros(shape, ctx=mx.gpu(0)))
    host = zoo_net(mx, name, mx.cpu(), prefix=card.prefix)
    mx.set_block_params(host, gluon_values(card))
    for net in (card, host):
        without_dropout(mx, net)
        net.hybridize()
    trainers = [gluon_trainer(mx, n, ZOO_CHECK_OPT) for n in (card, host)]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    data = [(rng.rand(*shape).astype(np.float32),
             rng.randint(0, CLASSES, GLUON_CHECK_BATCH).astype(np.float32))
            for _ in range(3)]
    steps, fails = [], []
    for k, (x, y) in enumerate(data[:2]):
        mx.set_block_params(host, gluon_values(card))
        if k == 0:
            gluon_record(mx, host, loss_fn, mx.nd.array(
                np.nextafter(x, np.float32(2)), ctx=mx.cpu()),
                mx.nd.array(y, ctx=mx.cpu()))
            moved_input = gluon_grads(host)
            mx.set_block_params(host, gluon_values(card))
        before = gluon_values(host)
        (out, loss), (out_ref, loss_ref) = (
            gluon_record(mx, n, loss_fn, mx.nd.array(x, ctx=ctx),
                         mx.nd.array(y, ctx=ctx))
            for n, ctx in ((card, mx.gpu(0)), (host, mx.cpu())))
        got, want = (o.data.detach().softmax(-1).cpu().numpy()
                     for o in (out, out_ref))
        stats, stats_ref = ({n: v for n, v in gluon_values(m).items()
                             if "running" in n} for m in (card, host))
        for what, a, b in (("outputs", got, want),
                           ("losses", loss.asnumpy(), loss_ref.asnumpy())):
            if not np.allclose(a, b, rtol=RESNET_RTOL, atol=RESNET_ATOL):
                fails.append("seed %d step %d %s" % (seed, k, what))
        stat_err = max_abs(stats, stats_ref)
        mean_noise = rounding_level(stats, stats_ref, "running_mean",
                                    "running_var", np.sqrt)
        stat_rel = leaf_errs(stats, stats_ref)
        if not stat_rel["max"] <= RESNET_RTOL:
            fails.append("seed %d step %d moving statistic %s: %.3g"
                         % (seed, k, stat_rel["worst"], stat_rel["max"]))
        grads, grads_ref = gluon_grads(card), gluon_grads(host)
        grad_noise = rounding_level(grads, grads_ref, "beta", "gamma")
        fails += ["seed %d step %d %s at rounding level reads %.3g of its "
                  "partner" % (seed, k, n, r) for n, r in
                  list(mean_noise.items()) + list(grad_noise.items())
                  if r > BIAS_NOISE]
        for t in trainers:
            t.step(GLUON_CHECK_BATCH)
        moved, moved_ref = ({n: v - before[n] for n, v in
                             gluon_values(m).items() if n in grads}
                            for m in (card, host))
        row = {"output_max_abs_err": float(np.abs(got - want).max()),
               "loss": [float(v) for v in loss.asnumpy()],
               "moving_stat_max_abs_err": stat_err,
               "moving_stat_rel": stat_rel,
               "at_rounding_level": {
                   "moving_means": noise_summary(mean_noise),
                   "beta_gradients": noise_summary(grad_noise)},
               "grad_rel": leaf_errs(grads, grads_ref),
               "update_rel": leaf_errs(moved, moved_ref)}
        if k == 0:
            row["floor_input_one_ulp_rel"] = leaf_errs(
                {n: moved_input[n] for n in grads_ref}, grads_ref)
        if k == 1:
            lr, wd = ZOO_CHECK_OPT["learning_rate"], ZOO_CHECK_OPT["wd"]
            plain = {n: -lr * (g / GLUON_CHECK_BATCH + wd * before[n])
                     for n, g in grads.items()}
            row["control_update_without_momentum_rel"] = leaf_errs(
                plain, moved_ref)
        steps.append(row)
    mx.set_block_params(host, gluon_values(card))
    x, y = data[2]
    gluon_record(mx, card, loss_fn, mx.nd.array(x, ctx=mx.gpu(0)),
                 mx.nd.array((y + 1) % CLASSES, ctx=mx.gpu(0)))
    gluon_record(mx, host, loss_fn, mx.nd.array(x, ctx=mx.cpu()),
                 mx.nd.array(y, ctx=mx.cpu()))
    controls = {
        "labels shifted on the card": leaf_errs(gluon_grads(card),
                                               gluon_grads(host)),
        "update without momentum":
            steps[1]["control_update_without_momentum_rel"]}
    summary = {"net": name, "seed": seed, "batch": GLUON_CHECK_BATCH,
               "opt": ZOO_CHECK_OPT, "median_limit": GRAD_REL,
               "worst_limit": ZOO_GRAD_REL, "steps": steps,
               "controls": controls}
    log("phase 28d %s f32 vs cpu %s" % (name, json.dumps(summary)))
    for k, row in enumerate(steps):
        for kind in ("grad_rel", "update_rel"):
            if not row[kind]["median"] <= GRAD_REL:
                fails.append("seed %d step %d %s median leaf: %.3g" % (
                    seed, k, kind, row[kind]["median"]))
            if not row[kind]["max"] <= ZOO_GRAD_REL:
                fails.append("seed %d step %d %s of %s: %.3g" % (
                    seed, k, kind, row[kind]["worst"], row[kind]["max"]))
    fails += ["seed %d control %s passes the median limit: %.3g"
              % (seed, what, reading["median"])
              for what, reading in controls.items()
              if reading["median"] <= GRAD_REL]
    return summary, fails


def phase_zoo_train(mx, rng, card):
    """Phase 28d: Inception-v3 (299) and MobileNet v2 (224) trained
    through phase 19's Gluon loop (f32, NCHW, batch 32, TF32 off, SGD
    momentum 0.9, hybridized): 2 warm-up and 10 timed steps on one fixed
    batch, whose loss must fall; img/s; one profiled step (busy, wall,
    idle share, device time by kernel class); then the card-vs-CPU
    check on ZOO_CHECK_SEEDS seeds, every net's and seed's fails
    reported together."""
    rows, fails = {}, []
    for name, size in ZOO_TRAINED:
        ctx = mx.gpu(0)
        net = zoo_net(mx, name, ctx)
        net.hybridize()
        trainer = gluon_trainer(mx, net, ZOO_OPT)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        x = mx.nd.array(rng.rand(ZOO_BATCH, 3, size, size).astype(
            np.float32), ctx=ctx)
        y = mx.nd.array(rng.randint(0, CLASSES, ZOO_BATCH).astype(
            np.float32), ctx=ctx)

        def step():
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(ZOO_BATCH)
            return loss

        step.trainer = trainer
        warm = [step() for _ in range(GLUON_WARMUP)]
        row = timed_gluon_steps(step, ZOO_BATCH)
        means = [float(v.data.detach().float().mean()) for v in warm] \
            + row["losses"]
        with ranged_ops([(trainer, "_update")]):
            prof = profiled_step(step)
        row.update(size=size, losses=means, card=card,
                   profile={k: prof[k] for k in (
                       "step_wall_ms", "device_busy_ms",
                       "device_idle_share", "kernels")},
                   classes={k: {"launches": v["launches"], "ms": v["ms"]}
                            for k, v in prof["classes"].items()},
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
        log("phase 28d %s trained %s" % (name, json.dumps(row)))
        check(means[-1] < means[0], "%s: the loss did not fall: %s"
              % (name, means))
        del net, trainer, step, x, y
        torch.cuda.empty_cache()
        row["check"] = []
        for seed in range(SEED + 282, SEED + 282 + ZOO_CHECK_SEEDS):
            summary, bad = phase_zoo_check(mx, name, size, seed)
            row["check"].append(summary)
            fails += ["%s %s" % (name, f) for f in bad]
            torch.cuda.empty_cache()
        rows[name] = row
    check(not fails, "zoo card vs cpu: " + "; ".join(fails))
    return rows


def linalg_inputs(rng):
    """{kind: f32 array}: SPD (A Aᵀ + n I), its lower Cholesky factor,
    SPD with eigenvalues 1..n (distinct, spaced 1 apart), plain, wide
    (n x 2n) and near-identity (I + G / (2 sqrt n), whose determinant is
    finite in f32) batches."""
    b, n = LINALG_BATCH, LINALG_N
    a = rng.randn(b, n, n)
    spd = a @ a.transpose(0, 2, 1) + n * np.eye(n)
    q = np.linalg.qr(rng.randn(b, n, n))[0]
    eig = (q * np.arange(1.0, n + 1)) @ q.transpose(0, 2, 1)
    return {"spd": spd.astype(np.float32),
            "chol": np.linalg.cholesky(spd).astype(np.float32),
            "eig": eig.astype(np.float32),
            "plain": rng.randn(b, n, n).astype(np.float32),
            "plain2": rng.randn(b, n, n).astype(np.float32),
            "wide": rng.randn(b, n, 2 * n).astype(np.float32),
            "near_eye": (np.eye(n) + rng.randn(b, n, n) / (2 * np.sqrt(n)))
            .astype(np.float32)}


LINALG_CARD_CASES = [
    ("gemm", {"alpha": 0.5, "beta": 2.0}, ("plain", "plain2", "spd")),
    ("gemm2", {"transpose_b": True}, ("plain", "plain2")),
    ("potrf", {}, ("spd",)),
    ("potri", {}, ("chol",)),
    ("trsm", {"alpha": 2.0}, ("chol", "plain")),
    ("trmm", {"rightside": True}, ("plain", "plain2")),
    ("sumlogdiag", {}, ("chol",)),
    ("syrk", {"alpha": 0.25}, ("plain",)),
    ("gelqf", {}, ("wide",)),
    ("syevd", {}, ("eig",)),
    ("inverse", {}, ("spd",)),
    ("det", {}, ("near_eye",)),
]


def linalg_run(mx, ctx, name, params, arrays, cots):
    """The op through ``nd.linalg`` on ``ctx`` under the tape: its outputs
    and its inputs' gradients of sum(cot * out) (``syevd``'s rows squared:
    eigenvectors are defined up to sign)."""
    xs = [mx.nd.array(a, ctx=ctx) for a in arrays]
    for x in xs:
        x.attach_grad()
    with mx.autograd.record():
        outs = getattr(mx.nd.linalg, name)(*xs, **params)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        loss = None
        for k, (o, c) in enumerate(zip(outs, cots)):
            term = ((o * o) if name == "syevd" and k == 0 else o) \
                * mx.nd.array(c, ctx=ctx)
            loss = term.sum() if loss is None else loss + term.sum()
    loss.backward()
    return [o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs]


def linalg_reading(got, want):
    """max |got - want| / max |want| over the finite values of ``want``
    (NaN positions must agree)."""
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        return float("inf")
    keep = ~np.isnan(want)
    scale = float(np.abs(want[keep]).max()) if keep.any() else 0.0
    diff = float(np.abs(got[keep] - want[keep]).max()) if keep.any() \
        else 0.0
    return diff / scale if scale else diff


def gaussian_loglik(mx):
    """A HybridBlock of the Gaussian log-likelihood of ``x`` under the
    covariance ``sigma`` (up to its constant): ``potrf`` -> ``trsm`` ->
    ``sumlogdiag``."""
    class LogLik(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, sigma, x):
            L = F.linalg.potrf(sigma)
            z = F.linalg.trsm(L, x)
            return -0.5 * F.sum(z * z, axis=(1, 2)) \
                - F.linalg.sumlogdiag(L)
    return LogLik()


def phase_linalg_card(mx, rng):
    """Phase 28e: every linalg op on gpu(0) against cpu(), forward and input
    gradients, by the largest difference over the largest magnitude
    (LINALG_REL; syevd LINALG_LIMITS's), eigenvectors compared squared; the
    control (the inputs rounded to bf16 on the card) must fail it.
    ``potrf`` of a batch with one matrix that is not positive definite
    reads NaN there, as on the CPU. A hybridized Gaussian log-likelihood
    (potrf -> trsm -> sumlogdiag) is captured or counted uncaptured, and
    its calls give the eager value."""
    from mxnet_tpu_torch import compiled
    inputs = linalg_inputs(rng)
    rows, fails = {}, []
    for name, params, kinds in LINALG_CARD_CASES:
        arrays = [inputs[k] for k in kinds]
        outs, _ = linalg_run(mx, mx.cpu(), name, params, arrays,
                             [np.zeros(1, np.float32)] * 2)
        cots = [rng.randn(*o.shape).astype(np.float32) for o in outs]
        want, want_g = linalg_run(mx, mx.cpu(), name, params, arrays, cots)
        got, got_g = linalg_run(mx, mx.gpu(0), name, params, arrays, cots)
        rounded = [a.astype(np.float32) for a in (
            mx.nd.array(a, ctx=mx.gpu(0), dtype="bfloat16").asnumpy()
            for a in arrays)]
        ctl, ctl_g = linalg_run(mx, mx.gpu(0), name, params, rounded, cots)
        if name == "syevd":     # the rows' signs are free: compare squares
            got[0], want[0], ctl[0] = (u * u for u in (got[0], want[0],
                                                       ctl[0]))
        row = {"forward": max(linalg_reading(a, b)
                              for a, b in zip(got, want)),
               "gradient": max(linalg_reading(a, b)
                               for a, b in zip(got_g, want_g)),
               "control": max([linalg_reading(a, b)
                               for a, b in zip(ctl, want)]
                              + [linalg_reading(a, b)
                                 for a, b in zip(ctl_g, want_g)])}
        limit = LINALG_LIMITS.get(name, LINALG_REL)
        row["limit"] = limit
        rows[name] = row
        if not (row["forward"] <= limit and row["gradient"] <= limit):
            fails.append("%s %s" % (name, row))
        if row["control"] <= limit:
            fails.append("%s: the control passes the limit (%.3g)"
                         % (name, row["control"]))
    bad = inputs["spd"][:4].copy()
    bad[1] = np.diag(np.r_[np.ones(LINALG_N - 1), -1.0]).astype(np.float32)
    nan_card, nan_cpu = (mx.nd.linalg.potrf(mx.nd.array(bad, ctx=c))
                         .asnumpy() for c in (mx.gpu(0), mx.cpu()))
    nan_row = {"nan_entries_card": int(np.isnan(nan_card).any((1, 2))
                                       .sum()),
               "reading": linalg_reading(nan_card, nan_cpu)}
    if not (nan_row["nan_entries_card"] == 1
            and np.isnan(nan_card[1]).any()
            and nan_row["reading"] <= LINALG_REL):
        fails.append("potrf of a non-PD entry: %s" % nan_row)
    block = gaussian_loglik(mx)
    sigma = mx.nd.array(inputs["spd"], ctx=mx.gpu(0))
    x = mx.nd.array(inputs["plain"], ctx=mx.gpu(0))
    eager = block(sigma, x).asnumpy()
    block.hybridize()
    before = compiled.compile_counts()
    calls = [block(sigma, x).asnumpy() for _ in range(3)]
    after = compiled.compile_counts()
    counts = {k: after[k] - before[k] for k in after}
    on_cpu = block(mx.nd.array(inputs["spd"], ctx=mx.cpu()),
                   mx.nd.array(inputs["plain"], ctx=mx.cpu())).asnumpy()
    loglik = {"compile_counts": counts,
              "calls_vs_eager": max(rel_err(c, eager) for c in calls),
              "vs_cpu": linalg_reading(calls[-1], on_cpu)}
    if not (counts["compiles"] == 1 and counts["cache_hits"] == 2
            and loglik["calls_vs_eager"] <= 1e-6
            and loglik["vs_cpu"] <= LINALG_REL):
        fails.append("the hybridized log-likelihood: %s" % loglik)
    summary = {"ops": rows, "potrf_not_pd": nan_row,
               "gaussian_loglik": loglik, "limit": LINALG_REL}
    log("phase 28e linalg card vs cpu %s" % json.dumps(summary))
    check(not fails, "linalg on the card: " + "; ".join(fails))
    return summary


def compat_card_cases(rng):
    """(name, params, inputs) of the compat ops held on the card."""
    x = rng.randn(8, 12).astype(np.float32)
    img = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
    return [
        ("_copyto", {}, [x]), ("_CrossDeviceCopy", {}, [x]),
        ("_grad_add", {}, [x, rng.randn(8, 12).astype(np.float32)]),
        ("_slice_assign", {"begin": (1, 0), "end": (5, 12),
                           "step": (2, 3)},
         [x, rng.randn(2, 4).astype(np.float32)]),
        ("_crop_assign", {"begin": (7, None), "end": (0, None),
                          "step": (-2, None)},
         [x, rng.randn(4, 12).astype(np.float32)]),
        ("_slice_assign_scalar", {"begin": (2,), "end": (6,),
                                  "scalar": 3.5}, [x]),
        ("_crop_assign_scalar", {"begin": (None, -4), "end": (None, None),
                                 "scalar": -1.0}, [x]),
        ("_image_to_tensor", {}, [img]),
        ("image_to_tensor", {}, [rng.uniform(0, 255, (4, 32, 32, 3))
                                 .astype(np.float32)]),
        ("_image_normalize", {"mean": (0.4, 0.5, 0.6),
                              "std": (0.2, 0.3, 0.5)},
         [rng.rand(3, 32, 32).astype(np.float32)]),
        ("image_normalize", {"mean": (0.4, 0.5, 0.6),
                             "std": (0.2, 0.3, 0.5)},
         [rng.rand(4, 3, 32, 32).astype(np.float32)]),
    ]


def phase_compat_card(mx, rng):
    """Phase 28f, part 1: the compat ops on gpu(0) against cpu() (the
    copies, the add and the assignments bit for bit, the image ops to
    1e-6 of the largest magnitude); IdentityAttachKLSparseReg's output,
    moving average and gradient in training; the two negative-binomial
    samplers' means and variances over NB_DRAWS draws a parameter within
    4 standard errors of their formulas."""
    rows, fails = {}, []
    for name, params, inputs in compat_card_cases(rng):
        got, want = (getattr(mx.nd, name)(*[mx.nd.array(
            a, ctx=c, dtype=a.dtype) for a in inputs], **params).asnumpy()
            for c in (mx.gpu(0), mx.cpu()))
        reading = linalg_reading(got.astype(np.float64),
                                 want.astype(np.float64))
        exact = not name.endswith("normalize")
        rows[name] = reading
        if got.shape != want.shape or reading > (0.0 if exact else 1e-6):
            fails.append("%s: %.3g" % (name, reading))
    data = rng.uniform(0.05, 0.95, (64, 32)).astype(np.float32)
    cot = rng.randn(64, 32).astype(np.float32)
    kl = {}
    for c in (mx.gpu(0), mx.cpu()):
        d = mx.nd.array(data, ctx=c)
        avg = mx.nd.array(np.full(32, 0.3, np.float32), ctx=c)
        d.attach_grad()
        with mx.autograd.record(train_mode=True):
            out = mx.nd.IdentityAttachKLSparseReg(d, avg, penalty=0.01)
            (out * mx.nd.array(cot, ctx=c)).sum().backward()
        kl[str(c)] = (out.asnumpy(), avg.asnumpy(), d.grad.asnumpy())
    (o, a, g), (o0, a0, g0) = kl[str(mx.gpu(0))], kl[str(mx.cpu())]
    rows["IdentityAttachKLSparseReg"] = max(
        linalg_reading(o, o0), linalg_reading(a, a0), linalg_reading(g, g0))
    if rows["IdentityAttachKLSparseReg"] > 1e-6:
        fails.append("IdentityAttachKLSparseReg: %.3g"
                     % rows["IdentityAttachKLSparseReg"])
    samplers = {}
    for name, p0, p1, mean, var in (
            ("_sample_negative_binomial", np.array([2.0, 7.0]),
             np.array([0.3, 0.6]), lambda k, p: k * (1 - p) / p,
             lambda k, p: k * (1 - p) / p ** 2),
            ("_sample_generalized_negative_binomial", np.array([3.0, 10.0]),
             np.array([0.5, 0.1]), lambda mu, al: mu,
             lambda mu, al: mu + al * mu ** 2)):
        mx.random.seed(SEED + 286)
        draws = getattr(mx.nd, name)(
            mx.nd.array(p0.astype(np.float32), ctx=mx.gpu(0)),
            mx.nd.array(p1.astype(np.float32), ctx=mx.gpu(0)),
            shape=(NB_DRAWS,))
        check(str(draws.data.device) == "cuda:0",
              "%s drew on %s" % (name, draws.data.device))
        d = draws.asnumpy().astype(np.float64)
        m, v = d.mean(1), d.var(1)
        m4 = ((d - m[:, None]) ** 4).mean(1)
        want_m, want_v = mean(p0, p1), var(p0, p1)
        sigmas = {"mean": (np.abs(m - want_m)
                           / np.sqrt(want_v / NB_DRAWS)).tolist(),
                  "var": (np.abs(v - want_v)
                          / np.sqrt((m4 - v ** 2) / NB_DRAWS)).tolist()}
        samplers[name] = {"mean": m.tolist(), "var": v.tolist(),
                          "want_mean": want_m.tolist(),
                          "want_var": want_v.tolist(), "sigmas": sigmas}
        if max(sigmas["mean"] + sigmas["var"]) > 4:
            fails.append("%s moments %s" % (name, sigmas))
    summary = {"readings": rows, "samplers": samplers}
    log("phase 28f compat ops %s" % json.dumps(summary))
    check(not fails, "compat ops on the card: " + "; ".join(fails))
    return summary


def breadth_mlp(mx):
    data = mx.sym.var("data")
    h = mx.sym.Activation(mx.sym.FullyConnected(
        mx.sym.Flatten(data), num_hidden=32, name="fc1"), act_type="relu")
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        h, num_hidden=10, name="fc2"), name="softmax")


def write_idx(path, arr):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def breadth_iterators(mx, tmp, rng):
    """{name: a function making the iterator}: over files written here
    (CSV, libsvm, gzipped idx) and arrays, 96 examples of 10 classes."""
    n, dim = 96, 64
    x = rng.rand(n, dim).astype(np.float32)
    y = rng.randint(0, 10, n)
    csv_x, csv_y = os.path.join(tmp, "x.csv"), os.path.join(tmp, "y.csv")
    np.savetxt(csv_x, x, delimiter=",")
    np.savetxt(csv_y, y, delimiter=",")
    svm = os.path.join(tmp, "x.libsvm")
    with open(svm, "w") as f:
        for row, label in zip(x, y):
            f.write("%d %s\n" % (label, " ".join(
                "%d:%.6f" % (j, v) for j, v in enumerate(row) if v > 0.5)))
    img, lbl = os.path.join(tmp, "img-idx3.gz"), os.path.join(tmp,
                                                              "lbl-idx1.gz")
    write_idx(img, (x.reshape(n, 8, 8) * 255).astype(np.uint8))
    write_idx(lbl, y)
    return {
        "CSVIter": lambda: mx.io.CSVIter(data_csv=csv_x, data_shape=(dim,),
                                         label_csv=csv_y, batch_size=16),
        "LibSVMIter": lambda: mx.io.LibSVMIter(data_libsvm=svm,
                                               data_shape=(dim,),
                                               batch_size=16),
        "MNISTIter": lambda: mx.io.MNISTIter(image=img, label=lbl,
                                             batch_size=16, shuffle=True,
                                             flat=True),
        "PrefetchingIter": lambda: mx.io.PrefetchingIter(mx.io.NDArrayIter(
            x, y.astype(np.float32), batch_size=16, shuffle=True)),
        "ResizeIter": lambda: mx.io.ResizeIter(mx.io.NDArrayIter(
            x, y.astype(np.float32), batch_size=16, shuffle=True), 4)}


def breadth_fit(mx, ctx, make_iter, arg_params):
    np.random.seed(SEED + 287)
    it = make_iter()
    mod = mx.mod.Module(breadth_mlp(mx), context=ctx)
    mod.fit(it, num_epoch=BREADTH_FIT_EPOCHS, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k: mx.nd.array(v, ctx=ctx)
                        for k, v in arg_params.items()},
            initializer=mx.init.Xavier())
    it.reset()
    out = mod.predict(it)
    args, _ = mod.get_params()
    return out.asnumpy(), {k: v.asnumpy() for k, v in args.items()}


def phase_breadth_rest(mx, rng, tmp, counters):
    """Phase 28f, part 2: ``Module.fit`` on gpu(0) fed by each file,
    prefetching and resizing iterator against the same fit on cpu()
    (outputs and parameters to PARAM_RTOL/ATOL); train_mnist.py through
    ``run_example`` under gpu(0) with ``--model-prefix``, its checkpoints
    loaded back through ``model.load_checkpoint`` and predicting the same
    on the card and on cpu(); ``FeedForward.fit``/``predict`` on gpu(0)
    against cpu()."""
    dim = 64
    r = np.random.RandomState(SEED + 288)
    arg_params = {"fc1_weight": (r.randn(32, dim) * 0.1).astype(np.float32),
                  "fc1_bias": np.zeros(32, np.float32),
                  "fc2_weight": (r.randn(10, 32) * 0.1).astype(np.float32),
                  "fc2_bias": np.zeros(10, np.float32)}
    rows, fails = {}, []
    for name, make in breadth_iterators(mx, tmp, rng).items():
        (out, args), (out0, args0) = (breadth_fit(mx, c, make, arg_params)
                                      for c in (mx.gpu(0), mx.cpu()))
        row = {"outputs_rel": rel_err(out, out0),
               "params_rel": max(rel_err(args[k], v)
                                 for k, v in args0.items()),
               "moved": max(rel_err(args0[k], v)
                            for k, v in arg_params.items())}
        rows[name] = row
        if not (np.allclose(out, out0, rtol=PARAM_RTOL, atol=PARAM_ATOL)
                and all(np.allclose(args[k], v, rtol=PARAM_RTOL,
                                    atol=PARAM_ATOL)
                        for k, v in args0.items()) and row["moved"] > 0):
            fails.append("Module.fit over %s: %s" % (name, row))
    prefix = os.path.join(tmp, "mnist")
    u1 = counters["multi_tensor_update"].launches
    run = run_example_captured(mx, "image-classification/train_mnist.py",
                               MNIST_ARGS + ["--model-prefix", prefix], "gpu")
    example = {"line": [ln for ln in run["lines"]
                        if "final validation" in ln][:1],
               "u1_launches": counters["multi_tensor_update"].launches - u1,
               "seconds": run["seconds"],
               "files": sorted(f for f in os.listdir(tmp)
                               if f.startswith("mnist"))}
    check(example["line"] and example["u1_launches"] > 0
          and example["files"] == ["mnist-0001.params", "mnist-0002.params",
                                   "mnist-symbol.json"],
          "train_mnist.py --model-prefix on gpu(0): %s" % example)
    x = rng.rand(40, 1, 28, 28).astype(np.float32)
    preds = {}
    for c in (mx.gpu(0), mx.cpu()):
        sym, arg, aux = mx.model.load_checkpoint(prefix, 2)
        mod = mx.mod.Module(sym, context=c)
        mod.bind([("data", (20, 1, 28, 28))], for_training=False)
        mod.set_params(arg, aux)
        preds[str(c)] = mod.predict(mx.io.NDArrayIter(x, batch_size=20)) \
            .asnumpy()
    first = mx.model.load_checkpoint(prefix, 1)[1]
    second = mx.model.load_checkpoint(prefix, 2)[1]
    example["checkpoint_predictions_rel"] = rel_err(preds[str(mx.gpu(0))],
                                                    preds[str(mx.cpu())])
    example["epoch_2_vs_1"] = max(rel_err(second[k].asnumpy(),
                                          v.asnumpy())
                                  for k, v in first.items())
    if not (example["checkpoint_predictions_rel"] <= INFER_REL
            and example["epoch_2_vs_1"] > 0):
        fails.append("train_mnist.py checkpoints: %s" % example)
    ff = {}
    xs = rng.rand(60, dim).astype(np.float32)
    ys = rng.randint(0, 10, 60).astype(np.float32)
    for c in (mx.gpu(0), mx.cpu()):
        model = mx.FeedForward(breadth_mlp(mx), ctx=c, num_epoch=2,
                               numpy_batch_size=20,
                               arg_params={k: mx.nd.array(v, ctx=c)
                                           for k, v in arg_params.items()},
                               aux_params={},
                               optimizer_params=(("learning_rate", 0.1),))
        np.random.seed(SEED + 289)
        model.fit(xs, ys)
        ff[str(c)] = (model.predict(xs), {k: v.asnumpy() for k, v in
                                          model.arg_params.items()})
    (p, a), (p0, a0) = ff[str(mx.gpu(0))], ff[str(mx.cpu())]
    feedforward = {"predict_rel": rel_err(p, p0),
                   "params_rel": max(rel_err(a[k], v)
                                     for k, v in a0.items())}
    if not (np.allclose(p, p0, rtol=PARAM_RTOL, atol=PARAM_ATOL)
            and all(np.allclose(a[k], v, rtol=PARAM_RTOL, atol=PARAM_ATOL)
                    for k, v in a0.items())):
        fails.append("FeedForward: %s" % feedforward)
    summary = {"module_fit": rows, "train_mnist": example,
               "feedforward": feedforward}
    log("phase 28f iterators, callbacks, FeedForward %s"
        % json.dumps(summary))
    check(not fails, "phase 28f: " + "; ".join(fails))
    return summary


def breadth_main():
    """Phase 28 in a process of its own (a fresh allocator and tracer):
    every kernel's count is set to 0, 28b-28f run (ResNet-50 with
    multi-precision Adam, the zoo served and trained, linalg, the compat
    ops, iterators, callbacks and FeedForward), and the counts are read.
    Prints its lines, then one JSON line with the launches (mp_adam's of
    28b apart)."""
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    t0 = time.perf_counter()
    ops = mx.ops
    counters = {"fused_lstm": ops.fused_lstm,
                "fused_lstm_train": ops.fused_lstm_train,
                "lstm_bwd_recurrence": ops.lstm_bwd_recurrence,
                "conv1x1_s2_dgrad": ops.conv1x1_s2_dgrad,
                "flash_attention": ops.flash_attention, "rtc": mx.rtc.Kernel,
                "multi_tensor_update": ops.multi_tensor_update,
                "greedy_nms": ops.greedy_nms,
                "sparse_row_update": ops.sparse_row_update}
    rng = np.random.RandomState(SEED + 28)
    seconds = {}
    for c in counters.values():               # the path starts here
        c.launches = 0
    t = time.perf_counter()
    resnet = phase_mp_adam_resnet(mx, rng)
    seconds["28b"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_zoo_serve(mx, rng, card)
    seconds["28c"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_zoo_train(mx, rng, card)
    seconds["28d"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_linalg_card(mx, rng)
    seconds["28e"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_compat_card(mx, rng)
    with tempfile.TemporaryDirectory() as tmp:
        phase_breadth_rest(mx, rng, tmp, counters)
    seconds["28f"] = time.perf_counter() - t
    launches = launches_of(counters)          # ... and ends here
    print(json.dumps({"phase": "28", "kernel_launches": launches,
                      "mp_adam_launches": resnet["mp_adam_launches"],
                      "seconds": seconds, "card": card,
                      "total_seconds": time.perf_counter() - t0}),
          flush=True)
    check(launches["conv1x1_s2_dgrad"] > 0
          and launches["multi_tensor_update"] > 0
          and not any(n for k, n in launches.items()
                      if k not in ("conv1x1_s2_dgrad",
                                   "multi_tensor_update")),
          "the breadth path launched %s: want K5 and U1 only" % launches)
    return 0


def phase_breadth_process():
    """Phase 28: ``breadth_main`` in a process of its own; its lines are
    logged, its launches and mp_adam's row returned."""
    t0 = time.perf_counter()
    last = run_own_process("--breadth", BREADTH_TIMEOUT_S,
                           log_prefix="phase 28")
    log("phase 28 seconds %.1f" % (time.perf_counter() - t0))
    return last


# ---------------------------------------------------------------------------
# Phase 29: Gluon files, hooks, export and SymbolBlock; gluon.contrib.rnn;
# the vision and WikiText datasets; contrib.autograd (a process of its own)
# ---------------------------------------------------------------------------
GLUON_FILES_TIMEOUT_S = 600
# 29a: ResNet-50 v1 from a weights file to a served SymbolBlock, at the
# image bench's configuration (tools/bench_all.py:91-97: NHWC, bf16, batch
# 128, SGD lr 0.05 with momentum 0.9, the K5 gate on)
FILES_OPT = {"learning_rate": RESNET_LR, "momentum": 0.9}
FILES_STEPS = 3                 # fine-tune steps after one warm-up step
FILES_SERVE_BATCHES = (32, 8)   # one signature each
FILES_SERVE_CALLS = 20
# the imported block's logits against the trained net's own hybridized
# forward, by relative norm: the same bf16 ops through the executor's
# graph, which rounds in other places (1.30e-3 at batch 32 and 1.39e-3 at
# batch 8 on an H100; PERF.md, phase 29). The control, the last
# BatchNorm's moving variance left at its initial value (what a loader
# that drops one layer's auxiliary state serves), read 6.8e-3 and must
# exceed it: the limit is about the geometric mean of 1.39e-3 and 6.8e-3
FILES_SERVE_REL = 3e-3
# 29b: gluon.contrib.rnn at full width
CONV_LSTM_INPUT = (16, 64, 32, 32)     # N, C, H, W
CONV_LSTM_HIDDEN, CONV_LSTM_STEPS = 64, 10
LSTMP_SHAPE = (32, 35, 650)            # N, T, input
LSTMP_HIDDEN, LSTMP_PROJ = 650, 200
CONTRIB_OPT = {"learning_rate": 0.1}
# card against cpu() from the same weights, f32 with TF32 off on both;
# relative norm per parameter (gradients and updates): sound readings up
# to 9.0e-5 (the conv cell's updates), controls 3.8e-3 (conv) and 0.114
# (LSTMP) on an H100 (PERF.md, phase 29)
CONTRIB_RNN_REL = 1e-3
VARDROP_P, VARDROP_WIDTH, VARDROP_STEPS = 0.5, 1 << 16, 8
# 29c: files in, batches out
MNIST_FILE_IMAGES, CIFAR_FILE_ROWS = 2048, 512    # a CIFAR batch file's
FILES_LOADER_BATCH = 128
WIKI_VOCAB, WIKI_LINES = 9000, 4000


def files_net(mx, ctx, **extra):
    """ResNet-50 v1 NHWC (``vision.resnet50_v1``) on ``ctx``."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    return vision.resnet50_v1(classes=CLASSES, layout="NHWC", ctx=ctx,
                              **extra)


def bit_equal_params(a, b):
    """Names of the parameters whose values or dtypes differ."""
    pa, pb = a.collect_params(), b.collect_params()
    return [n for (n, p), q in zip(pa.items(), pb.values())
            if p.data().data.dtype != q.data().data.dtype
            or not torch.equal(p.data().data, q.data().data)]


def phase_files_resnet(mx, rng, tmp, counters):
    """29a: a seeded net saved and loaded through
    ``pretrained=True`` (bit-equal), 3 fine-tune steps (K5 6 and U1 1 a
    step), the file round trips (bit-equal), ``export`` ->
    ``SymbolBlock.imports`` served at two batch sizes (one capture a
    signature, none under load, one ``cudaGraphLaunch`` a call, logits
    against the net's own hybridized forward with a control), and the
    pair through ``Predictor`` (the same probabilities) and ``Module``
    (refused, as the JAX package refuses it)."""
    ctx = mx.gpu(0)
    os.environ["MXNET_CONV1X1_PALLAS"] = "1"
    batch = RESNET_BATCH
    x = mx.nd.array(rng.rand(*gluon_shape("NHWC", batch)), ctx=ctx,
                    dtype="bfloat16")
    y = mx.nd.array(rng.randint(0, CLASSES, batch), ctx=ctx,
                    dtype=np.float32)
    # 1-2: a seeded net saved under root, loaded by pretrained=True
    mx.random.seed(SEED + 29)
    seeded = gluon_net(mx, ctx, "NHWC")
    seeded.cast("bfloat16")
    with mx.autograd.pause():
        want = seeded(x).data.clone()
    root = os.path.join(tmp, "models")
    os.makedirs(root)
    seeded.save_parameters(os.path.join(root, "resnet50_v1.params"))
    net = files_net(mx, ctx, pretrained=True, root=root)
    loaded_dtypes = sorted({str(p.data().data.dtype)
                            for p in net.collect_params().values()})
    net.cast("bfloat16")
    with mx.autograd.pause():
        got = net(x).data.clone()
    pretrained = {"loaded_dtypes": loaded_dtypes,
                  "params_differing": bit_equal_params(net, seeded),
                  "forward_bit_equal": bool(torch.equal(got, want))}
    log("phase 29a pretrained %s" % json.dumps(pretrained))
    check(not pretrained["params_differing"]
          and pretrained["forward_bit_equal"],
          "pretrained=True did not give the saved net: %s" % pretrained)
    del seeded, want, got
    # 3: fine-tune under record() and Trainer, hybridized
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(FILES_OPT),
                               kvstore="device")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(batch)
        return loss
    before = launches_of(counters)
    losses = [float(step().data.detach().float().mean())]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step() for _ in range(FILES_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = losses[:1] + [float(v.data.detach().float().mean())
                           for v in losses[1:]]
    tuned = launched(counters, before)
    steps = FILES_STEPS + 1
    finetune = {"steps": steps, "imgs_per_s": FILES_STEPS * batch / wall,
                "step_ms": wall * 1e3 / FILES_STEPS, "losses": losses,
                "launches": {k: n for k, n in tuned.items() if n}}
    log("phase 29a fine-tune %s" % json.dumps(finetune))
    check(tuned["conv1x1_s2_dgrad"] == K5_PER_STEP * steps
          and tuned["multi_tensor_update"] == steps
          and not any(n for k, n in tuned.items()
                      if k not in ("conv1x1_s2_dgrad",
                                   "multi_tensor_update")),
          "the fine-tune launched %s in %d steps: want K5 %d and U1 1 a "
          "step, no other" % (tuned, steps, K5_PER_STEP))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "the fine-tune's loss did not fall: %s" % losses)
    # 4: the file round trips
    sizes = {}
    trips = {}
    with mx.autograd.pause():
        want = net(x).data.clone()
    for save, load in (("save_parameters", "load_parameters"),
                       ("save_params", "load_params")):
        path = os.path.join(tmp, "tuned_%s.params" % save)
        getattr(net, save)(path)
        sizes[save] = os.path.getsize(path)
        again = files_net(mx, ctx, prefix=net.prefix)
        getattr(again, load)(path, ctx=ctx)
        again.cast("bfloat16")
        again.hybridize()
        with mx.autograd.pause():
            out = again(x).data
        trips[save] = {"params_differing": bit_equal_params(again, net),
                       "forward_bit_equal": bool(torch.equal(out, want))}
        del again, out
    log("phase 29a round trips %s" % json.dumps(trips))
    check(all(not t["params_differing"] and t["forward_bit_equal"]
              for t in trips.values()),
          "a file round trip changed the net: %s" % trips)
    # 5-6: export, SymbolBlock.imports, served
    prefix = os.path.join(tmp, "resnet50_v1_tuned")
    net.export(prefix)
    sizes["symbol_json"] = os.path.getsize(prefix + "-symbol.json")
    sizes["export_params"] = os.path.getsize(prefix + "-0000.params")
    block = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                         prefix + "-0000.params", ctx=ctx)
    block.cast("bfloat16")
    mx.compiled.reset()
    inputs = {b: mx.nd.array(rng.rand(*gluon_shape("NHWC", b)), ctx=ctx,
                             dtype="bfloat16")
              for b in FILES_SERVE_BATCHES}
    with mx.autograd.pause():
        for b, xb in inputs.items():
            block(xb)
        warm = mx.compiled.compile_counts()
        for _ in range(FILES_SERVE_CALLS):
            for xb in inputs.values():
                block(xb)
        torch.cuda.synchronize()
        after = mx.compiled.compile_counts()
        xs = inputs[FILES_SERVE_BATCHES[0]]
        served = block(xs).data.double()     # f64: no norm overflows
        own = net(xs).data.double()
        profile = call_profile(lambda: block(xs))
        reading = rel_err(served.cpu().numpy(), own.cpu().numpy())
        # the control: the last BatchNorm's moving variance at its
        # initial value; every other BatchNorm's is read too, to print
        # how many such faults the limit catches
        one_bn = []
        for n, p in block.collect_params().items():
            if n.endswith("running_var"):
                saved = p.data().data.clone()
                p.data().data.fill_(1.0)
                r = rel_err(block(xs).data.double().cpu().numpy(),
                            own.cpu().numpy())
                one_bn.append(r if np.isfinite(r) else float("inf"))
                p.data().data.copy_(saved)
        control = one_bn[-1]
        readings = [reading] + [rel_err(
            block(xb).data.double().cpu().numpy(),
            net(xb).data.double().cpu().numpy())
            for xb in list(inputs.values())[1:]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FILES_SERVE_CALLS):
            block(xs)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3 / FILES_SERVE_CALLS
    serve = {"batches": list(FILES_SERVE_BATCHES),
             "compile_counts_after_warmup": warm,
             "compile_counts_after_calls": after,
             "rel_vs_gluon_hybridized": readings, "control_rel": control,
             "one_batchnorm_faults": {
                 "count": len(one_bn),
                 "caught": sum(r > FILES_SERVE_REL for r in one_bn),
                 "min": min(one_bn), "median": float(np.median(one_bn)),
                 "max": max(one_bn)},
             "limit": FILES_SERVE_REL, "call_wall_ms": call_ms,
             "profiled_wall_ms": profile["wall_ms"],
             "device_busy_ms": profile["device_busy_ms"],
             "runtime_calls": profile["runtime_calls"]}
    log("phase 29a served SymbolBlock %s" % json.dumps(serve))
    check(warm["compiles"] == len(FILES_SERVE_BATCHES)
          and warm["uncaptured"] == 0
          and after["compiles"] == warm["compiles"]
          and after["retraces"] == 0,
          "the SymbolBlock compiled %s after warm-up and %s after %d calls: "
          "want one capture a signature, none under load"
          % (warm, after, FILES_SERVE_CALLS))
    check(profile["runtime_calls"].get("cudaGraphLaunch") == 1
          and not profile["runtime_calls"].get("cudaLaunchKernel"),
          "a served call made %s runtime calls: want one cudaGraphLaunch "
          "and no kernel launch" % profile["runtime_calls"])
    check(max(readings) < FILES_SERVE_REL < control,
          "the imported block read %s against the Gluon net and its "
          "control %.4g (limit %g)" % (readings, control, FILES_SERVE_REL))
    # 7: the pair through the Predictor and Module
    with open(prefix + "-symbol.json") as f:
        sym_json = f.read()
    with open(prefix + "-0000.params", "rb") as f:
        blob = f.read()
    pred = mx.Predictor(sym_json, blob, ctx=ctx,
                        input_shapes={"data": tuple(xs.shape)})
    # the Predictor binds f32 arguments: feed the f32 widening of the same
    # bf16 images, and compare with the SymbolBlock served in f32
    f32_block = mx.gluon.SymbolBlock.imports(
        prefix + "-symbol.json", "data", prefix + "-0000.params", ctx=ctx)
    xs32 = xs.astype("float32")
    with mx.autograd.pause():
        want32 = f32_block(xs32).data.float()
    pred.forward(data=xs32.asnumpy())
    probs = mx.nd.softmax(mx.nd.array(pred.get_output(0), ctx=ctx)).data
    want_probs = torch.softmax(want32, dim=-1)
    predictor = {"max_abs_prob_diff": float((probs - want_probs).abs()
                                            .max()),
                 "top1_agree": float((probs.argmax(1) == want_probs
                                      .argmax(1)).float().mean())}
    sym, arg, aux = mx.model.load_checkpoint(prefix, 0)
    mod = mx.mod.Module(sym, data_names=["data"], label_names=None,
                        context=ctx)
    mod.bind(data_shapes=[("data", tuple(xs.shape))], for_training=False)
    try:
        mod.set_params(arg, aux)
        predictor["module"] = "loaded"
    except RuntimeError as e:
        predictor["module"] = "refused: %s" % str(e)[:80]
    log("phase 29a predictor and module %s" % json.dumps(predictor))
    check(predictor["max_abs_prob_diff"] < 1e-5
          and predictor["top1_agree"] == 1.0,
          "the Predictor's probabilities differ from the SymbolBlock's: %s"
          % predictor)
    check(predictor["module"].startswith("refused"),
          "Module.set_params took the exported pair, which the JAX "
          "package refuses: %s" % predictor["module"])
    log("phase 29a file sizes %s" % json.dumps(sizes))
    del net, block, f32_block, pred, mod
    torch.cuda.empty_cache()
    return {"pretrained": pretrained, "finetune": finetune,
            "round_trips": trips, "serve": serve, "predictor": predictor,
            "file_bytes": sizes}


def contrib_rnn_steps(mx, make, x_np, name):
    """2 recorded SGD steps of the cell ``make(prefix)`` unrolled over
    ``x_np`` (NTC) on gpu(0) and cpu() from the same weights; per step the
    gradients and the updates by relative norm per parameter, and the
    control (the card's second update against the CPU's first)."""
    nets = {}
    for dev, ctx in (("card", mx.gpu(0)), ("host", mx.cpu())):
        cell = make("crnn_%s_" % name)
        mx.random.seed(SEED + 29)
        cell.initialize(mx.init.Xavier(), ctx=ctx)
        nets[dev] = (cell, ctx, mx.gluon.Trainer(
            cell.collect_params(), "sgd", dict(CONTRIB_OPT)))
    steps = x_np.shape[1]
    r = np.random.RandomState(SEED + 290).randn(
        *x_np.shape[:2]).astype(np.float32)

    def backward(cell, ctx):
        x = mx.nd.array(x_np, ctx=ctx)
        with mx.autograd.record():
            out, _ = cell.unroll(steps, x, layout="NTC", merge_outputs=True)
            flat = out.reshape((x_np.shape[0], steps, -1))
            loss = (flat.mean(axis=2) * mx.nd.array(r, ctx=ctx)).sum() \
                + (flat * flat).mean()
        loss.backward()

    card_cell, host_cell = nets["card"][0], nets["host"][0]
    rows, prev = [], None
    for _ in range(2):
        start = gluon_values(card_cell)
        mx.set_block_params(host_cell, start)
        for cell, ctx, trainer in nets.values():
            backward(cell, ctx)
        got, want = gluon_grads(card_cell), gluon_grads(host_cell)
        for _, _, trainer in nets.values():
            trainer.step(x_np.shape[0])
        moved = {n: v - start[n] for n, v in gluon_values(card_cell).items()}
        moved_ref = {n: v - start[n]
                     for n, v in gluon_values(host_cell).items()}
        row = {"grad_rel": leaf_errs(got, want),
               "update_rel": leaf_errs(moved, moved_ref)}
        if prev is not None:
            row["control_second_vs_first"] = max(
                rel_err(moved[n], prev[n]) for n in moved)
        prev = moved_ref
        rows.append(row)
    return rows


def phase_files_contrib_rnn(mx, counters):
    """29b: a Conv2DLSTMCell and an LSTMPCell trained 2 steps on the card
    against the CPU (no hand kernel but the Trainer's U1: their
    convolutions and products are library calls), and
    VariationalDropoutCell's masks on the card."""
    rng = np.random.RandomState(SEED + 291)
    before = launches_of(counters)
    n, c, h, w = CONV_LSTM_INPUT
    conv_x = rng.randn(n, CONV_LSTM_STEPS, c, h, w).astype(np.float32)
    conv = contrib_rnn_steps(mx, lambda prefix: mx.gluon.contrib.rnn
                             .Conv2DLSTMCell((c, h, w), CONV_LSTM_HIDDEN, 3,
                                             3, i2h_pad=1, prefix=prefix),
                             conv_x, "conv2dlstm")
    lstmp_x = rng.randn(*LSTMP_SHAPE).astype(np.float32)
    lstmp = contrib_rnn_steps(mx, lambda prefix: mx.gluon.contrib.rnn
                              .LSTMPCell(LSTMP_HIDDEN, LSTMP_PROJ,
                                         input_size=LSTMP_SHAPE[2],
                                         prefix=prefix),
                              lstmp_x, "lstmp")
    rows = {"conv2d_lstm": conv, "lstmp": lstmp, "limit": CONTRIB_RNN_REL}
    log("phase 29b contrib.rnn vs cpu %s" % json.dumps(rows))
    for name in ("conv2d_lstm", "lstmp"):
        check(all(r[k]["max"] < CONTRIB_RNN_REL for r in rows[name]
                  for k in ("grad_rel", "update_rel")),
              "%s: a gradient or update differs from the CPU's beyond %g"
              % (name, CONTRIB_RNN_REL))
        check(rows[name][1]["control_second_vs_first"] > CONTRIB_RNN_REL,
              "%s: the control passed the limit %g" % (name,
                                                       CONTRIB_RNN_REL))

    class Echo(mx.gluon.rnn.HybridRecurrentCell):
        """Output = input: a dropped input shows its mask."""

        def state_info(self, batch_size=0):
            return [{"shape": (batch_size, VARDROP_WIDTH),
                     "__layout__": "NC"}]

        def hybrid_forward(self, F, inputs, states):
            return inputs, states
    cell = mx.gluon.contrib.rnn.VariationalDropoutCell(
        Echo(prefix="echo_"), drop_inputs=VARDROP_P)
    ones = mx.nd.ones((2, VARDROP_STEPS, VARDROP_WIDTH), ctx=mx.gpu(0))
    with mx.autograd.record():
        out, _ = cell.unroll(VARDROP_STEPS, ones, layout="NTC",
                             merge_outputs=True)
    m = out.data
    kept = float((m[:, 0] != 0).float().mean())
    sigma = float(np.sqrt(VARDROP_P * (1 - VARDROP_P) / m[:, 0].numel()))
    vardrop = {"device": str(m.device), "keep_rate": kept,
               "want": 1 - VARDROP_P, "sigma": sigma,
               "same_mask_every_step": bool(all(
                   torch.equal(m[:, t], m[:, 0])
                   for t in range(VARDROP_STEPS))),
               "values": sorted({round(float(v), 6)
                                 for v in torch.unique(m).tolist()})}
    log("phase 29b variational dropout %s" % json.dumps(vardrop))
    check(m.is_cuda and vardrop["same_mask_every_step"]
          and abs(kept - (1 - VARDROP_P)) <= 4 * sigma
          and vardrop["values"] == [0.0, round(1 / (1 - VARDROP_P), 6)],
          "VariationalDropoutCell's mask on the card: %s" % vardrop)
    launches = launched(counters, before)
    # the cells' ops are library calls; the card's Trainer steps are U1,
    # one a step of each cell
    check(launches["multi_tensor_update"] == 4
          and not any(n for k, n in launches.items()
                      if k != "multi_tensor_update"),
          "gluon.contrib.rnn launched %s: want U1 once a card step (4) "
          "and no other kernel" % launches)
    return {"vs_cpu": rows, "variational_dropout": vardrop}


def wiki_tokens(rng):
    """A WikiText-format file's text: headings and lines of words drawn
    from a WIKI_VOCAB-word vocabulary (with ``<unk>`` in it)."""
    words = ["w%d" % i for i in range(WIKI_VOCAB - 1)] + ["<unk>"]
    lines = []
    for i in range(WIKI_LINES):
        if i % 50 == 0:
            lines += ["", " = Heading %d = " % (i // 50), ""]
        n = rng.randint(5, 30)
        lines.append(" " + " ".join(words[j] for j in rng.randint(
            0, len(words), n)) + " . ")
    return "\n".join(lines) + "\n"


def phase_files_data(mx, tmp, counters):
    """29c: MNIST and CIFAR-10 files through ``vision`` + ``transforms`` +
    ``DataLoader`` (batches equal numpy's), a WikiText-2 token file
    through ``WikiText2`` + ``IntervalSampler`` into one step of the 2x650
    LM as ``gluon.rnn.LSTM`` (K2 and K3 2 each, U1 1), and
    ``contrib.autograd.grad_and_loss`` on the card against ``autograd``."""
    rng = np.random.RandomState(SEED + 292)
    vision = mx.gluon.data.vision
    t = vision.transforms
    # MNIST
    mroot = os.path.join(tmp, "mnist")
    os.makedirs(mroot)
    images = rng.randint(0, 256, (MNIST_FILE_IMAGES, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, MNIST_FILE_IMAGES).astype(np.uint8)
    write_idx(os.path.join(mroot, "train-images-idx3-ubyte.gz"), images)
    write_idx(os.path.join(mroot, "train-labels-idx1-ubyte.gz"), labels)
    tf = t.ToTensor()
    mnist = vision.MNIST(root=mroot, transform=lambda x, y: (tf(x), y))
    loader = mx.gluon.data.DataLoader(mnist, batch_size=FILES_LOADER_BATCH)
    mnist_ok, n_batches = True, 0
    for k, (xb, yb) in enumerate(loader):
        lo = k * FILES_LOADER_BATCH
        want = images[lo:lo + FILES_LOADER_BATCH, None].astype(np.float32) \
            / 255.0
        mnist_ok &= bool(np.array_equal(xb.asnumpy(), want)
                         and np.array_equal(yb.asnumpy(),
                                            labels[lo:lo + len(want)]))
        n_batches += 1
    # CIFAR-10, the batches normalised and moved to the card
    croot = os.path.join(tmp, "cifar", "cifar-10-batches-bin")
    os.makedirs(croot)
    rows, cif = [], []
    for i in range(1, 6):
        lab = rng.randint(0, 10, (CIFAR_FILE_ROWS, 1)).astype(np.uint8)
        img = rng.randint(0, 256, (CIFAR_FILE_ROWS, 3072)).astype(np.uint8)
        with open(os.path.join(croot, "data_batch_%d.bin" % i), "wb") as f:
            f.write(np.concatenate([lab, img], axis=1).tobytes())
        rows.append(lab[:, 0])
        cif.append(img.reshape(-1, 3, 32, 32))
    cif, rows = np.concatenate(cif), np.concatenate(rows)
    mean = np.array([0.4914, 0.4822, 0.4465], np.float32)
    std = np.array([0.247, 0.243, 0.261], np.float32)
    norm = t.Compose([t.Cast("float32"), t.ToTensor(),
                      t.Normalize(mean, std)])
    cifar = vision.CIFAR10(root=os.path.dirname(croot),
                           transform=lambda x, y: (norm(x), y))
    loader = mx.gluon.data.DataLoader(cifar, batch_size=FILES_LOADER_BATCH,
                                      shuffle=False)
    cifar_err, cifar_labels_ok = 0.0, True
    for k, (xb, yb) in enumerate(loader):
        lo = k * FILES_LOADER_BATCH
        on_card = xb.as_in_context(mx.gpu(0))
        want = (cif[lo:lo + FILES_LOADER_BATCH].astype(np.float32) / 255.0
                - mean[:, None, None]) / std[:, None, None]
        cifar_err = max(cifar_err, float(np.abs(on_card.asnumpy()
                                                - want).max()))
        cifar_labels_ok &= bool(np.array_equal(yb.asnumpy(),
                                               rows[lo:lo + len(want)]))
    data_row = {"mnist_batches": n_batches, "mnist_equal": mnist_ok,
                "cifar_images": len(cifar), "cifar_max_abs_err": cifar_err,
                "cifar_labels_equal": cifar_labels_ok}
    log("phase 29c vision %s" % json.dumps(data_row))
    check(mnist_ok and cifar_labels_ok and cifar_err <= 1e-6
          and len(cifar) == 5 * CIFAR_FILE_ROWS,
          "the vision datasets' batches differ from numpy's: %s" % data_row)
    # WikiText-2 into one step of the 2x650 LM
    wroot = os.path.join(tmp, "wikitext-2")
    os.makedirs(wroot)
    with open(os.path.join(wroot, "wiki.train.tokens"), "w") as f:
        f.write(wiki_tokens(rng))
    wiki = mx.gluon.contrib.data.WikiText2(root=wroot, seq_len=SEQ)
    vocab = len(wiki.vocabulary)
    sampler = mx.gluon.contrib.data.IntervalSampler(len(wiki), TRAIN_BATCH)
    loader = mx.gluon.data.DataLoader(wiki, batch_size=TRAIN_BATCH,
                                      sampler=sampler, last_batch="discard")
    xb, yb = next(iter(loader))
    card = gluon_lm(mx, mx.gpu(0))
    trainer = mx.gluon.Trainer(card.collect_params(), "sgd", dict(TRAIN_OPT))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x = xb.as_in_context(mx.gpu(0)).astype("float32").T
    y = yb.as_in_context(mx.gpu(0)).astype("float32").T
    before = launches_of(counters)
    loss = gluon_lm_step(mx, card, trainer, loss_fn, x, y)
    torch.cuda.synchronize()
    lm = {"vocabulary": vocab, "windows": len(wiki),
          "first_batch_rows": [int(i) for i in list(sampler)[:3]],
          "loss": float(loss.mean().asscalar()),
          "launches": {k: n for k, n in launched(counters, before).items()
                       if n}}
    log("phase 29c wikitext LM step %s" % json.dumps(lm))
    check(vocab <= VOCAB and lm["launches"] == {
        "fused_lstm_train": LAYERS, "lstm_bwd_recurrence": LAYERS,
        "multi_tensor_update": 1} and np.isfinite(lm["loss"]),
          "the WikiText step launched %s (vocabulary %d): want K2 and K3 "
          "%d each and U1 once" % (lm["launches"], vocab, LAYERS))
    del card
    # contrib.autograd on the card against autograd
    a = mx.nd.array(rng.randn(4096).astype(np.float32), ctx=mx.gpu(0))
    b = mx.nd.array(rng.randn(4096).astype(np.float32), ctx=mx.gpu(0))

    def f(p, q):
        return (p * p * q + mx.nd.sin(p)).sum()
    (ga, gb), value = mx.contrib.autograd.grad_and_loss(f)(a, b)
    a2, b2 = a.copy(), b.copy()
    a2.attach_grad()
    b2.attach_grad()
    with mx.autograd.record():
        v2 = f(a2, b2)
    v2.backward()
    ag = {"device": str(ga.data.device),
          "grad_max_abs_diff": max(
              float((ga.data - a2.grad.data).abs().max()),
              float((gb.data - b2.grad.data).abs().max())),
          "loss_diff": abs(float(value.asscalar()) - float(v2.asscalar()))}
    log("phase 29c contrib.autograd %s" % json.dumps(ag))
    check(ga.data.is_cuda and ag["grad_max_abs_diff"] == 0.0
          and ag["loss_diff"] == 0.0,
          "contrib.autograd on the card differs from autograd: %s" % ag)
    return {"vision": data_row, "wikitext": lm, "autograd": ag}


def gluon_files_main():
    """Phase 29 in a process of its own: every kernel's count is set to
    0, 29a-29c run, and the counts are read. Prints its lines, then one
    JSON line with the launches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    card = nvidia_smi()
    t0 = time.perf_counter()
    ops = mx.ops
    counters = {"fused_lstm": ops.fused_lstm,
                "fused_lstm_train": ops.fused_lstm_train,
                "lstm_bwd_recurrence": ops.lstm_bwd_recurrence,
                "conv1x1_s2_dgrad": ops.conv1x1_s2_dgrad,
                "flash_attention": ops.flash_attention, "rtc": mx.rtc.Kernel,
                "multi_tensor_update": ops.multi_tensor_update,
                "greedy_nms": ops.greedy_nms,
                "sparse_row_update": ops.sparse_row_update}
    rng = np.random.RandomState(SEED + 29)
    seconds = {}
    for c in counters.values():               # the path starts here
        c.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        resnet = phase_files_resnet(mx, rng, tmp, counters)
        seconds["29a"] = time.perf_counter() - t
        t = time.perf_counter()
        phase_files_contrib_rnn(mx, counters)
        seconds["29b"] = time.perf_counter() - t
        t = time.perf_counter()
        phase_files_data(mx, tmp, counters)
        seconds["29c"] = time.perf_counter() - t
    launches = launches_of(counters)          # ... and ends here
    print(json.dumps({"phase": "29", "kernel_launches": launches,
                      "finetune_imgs_per_s": resnet["finetune"][
                          "imgs_per_s"],
                      "served_call_ms": resnet["serve"]["call_wall_ms"],
                      "seconds": seconds, "card": card,
                      "total_seconds": time.perf_counter() - t0}),
          flush=True)
    check(launches["conv1x1_s2_dgrad"] > 0
          and launches["multi_tensor_update"] > 0
          and launches["fused_lstm_train"] > 0
          and launches["lstm_bwd_recurrence"] > 0
          and not any(n for k, n in launches.items()
                      if k not in ("conv1x1_s2_dgrad", "multi_tensor_update",
                                   "fused_lstm_train", "lstm_bwd_recurrence",
                                   "fused_lstm")),
          "the Gluon files path launched %s: want K5, U1, K2 and K3 (K1 at "
          "the LM's deferred-init forward)" % launches)
    return 0


def phase_gluon_files_process():
    """Phase 29: ``gluon_files_main`` in a process of its own; its lines
    are logged, its JSON line returned."""
    t0 = time.perf_counter()
    last = run_own_process("--gluon-files", GLUON_FILES_TIMEOUT_S,
                           log_prefix="phase 29")
    log("phase 29 seconds %.1f" % (time.perf_counter() - t0))
    return last


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; it runs the port on the GPU",
              file=sys.stderr)
        return 2
    script_t0 = time.perf_counter()
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
    # score's inference forwards: a replay a batch, and each signature's
    # capture runs the forward WARMUP_RUNS times before it
    want = LAYERS * (EVAL_BATCHES + mx.compiled.WARMUP_RUNS
                     * summary["score_compiles"])
    check(summary["score_compiles"] == 1
          and summary["k1_launches_by_score"] == want,
          "score compiled %d signatures and launched fused_lstm %d times, "
          "want 1 and %d" % (summary["score_compiles"],
                             summary["k1_launches_by_score"], want))
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
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    s1_summary = phase_s1(mx)
    phase_sparse_card_vs_cpu(mx)
    s1 = mx.ops.sparse_row_update
    path = dict(counters, multi_tensor_update=u1, greedy_nms=n1,
                sparse_row_update=s1)
    for c in path.values():                   # the sparse path starts
        c.launches = 0
    loop = phase_sparse_loop(mx)
    sparse_examples = phase_sparse_examples(mx, path)
    sp_launches = {k: c.launches for k, c in path.items()}   # ... ends here
    log("phase 23 sparse %s" % json.dumps({
        "kernel_launches": sp_launches, "card": card,
        "step_ms": loop["step_ms"],
        "defaults_outcome": sparse_examples["sparse_embedding_defaults"][
            "outcome"], "seconds": time.perf_counter() - t0}))
    check(sp_launches["sparse_row_update"] > 0
          and not any(n for k, n in sp_launches.items()
                      if k not in ("sparse_row_update",
                                   "multi_tensor_update")),
          "the sparse path launched %s: want S1 (and U1) only" % sp_launches)

    rnn_launches, _ = phase_rnn(mx, path, np.random.RandomState(SEED + 24),
                                device)
    speech_launches, _ = phase_speech(
        mx, path, np.random.RandomState(SEED + 25))
    obs_launches = phase_observability(mx)
    serving_launches = phase_serving_process()
    breadth = phase_breadth_process()
    breadth_launches = breadth["kernel_launches"]
    files_launches = phase_gluon_files_process()["kernel_launches"]

    top = next(r for r in rows
               if (r["T"], r["B"]) == (SEQ, max(SERVED_BATCHES)))
    train = next(r for r in train_rows if (r["T"], r["B"]) == (SEQ,
                                                              TRAIN_BATCH))
    pallas = "mxnet_tpu/ops/pallas_kernels.py"
    k3_src = "mxnet_tpu_torch/csrc/lstm_bwd_persistent.cuh"
    recurrence_src = "mxnet_tpu_torch/csrc/lstm_persistent.cuh"
    kernels = [{
        "name": "fused_lstm", "route": "cuda", "source": recurrence_src,
        "replaces": pallas + ":295",
        "launches": (launches + rnn_launches["fused_lstm"]
                     + speech_launches["fused_lstm"] + serving_launches
                     + files_launches["fused_lstm"]),
        "max_abs_err": worst,
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"]}, {
        "name": "fused_lstm_train", "route": "cuda",
        "source": recurrence_src,
        "replaces": pallas + ":348",
        "launches": (k2 + rnn_launches["fused_lstm_train"]
                     + speech_launches["fused_lstm_train"]
                     + files_launches["fused_lstm_train"]),
        "max_abs_err": train_worst, "ms": train["k2_ms"],
        "plain_ms": train["k2_plain_ms"], "bound_ms": train["k2_bound_ms"],
        "bound_by": train["k2_bound_by"],
        "library_ms": train["cudnn_fwd_ms"]}, {
        "name": "lstm_bwd_recurrence", "route": "cuda", "source": k3_src,
        "replaces": pallas + ":382",
        "launches": (k3 + rnn_launches["lstm_bwd_recurrence"]
                     + speech_launches["lstm_bwd_recurrence"]
                     + files_launches["lstm_bwd_recurrence"]),
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
        "launches": (k5_launches + gluon_k5
                     + obs_launches["conv1x1_s2_dgrad"]
                     + breadth_launches["conv1x1_s2_dgrad"]
                     + files_launches["conv1x1_s2_dgrad"]),
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
        "launches": (opt_launches["multi_tensor_update"]
                     + rnn_launches["multi_tensor_update"]
                     + speech_launches["multi_tensor_update"]
                     + obs_launches["multi_tensor_update"]
                     + breadth_launches["multi_tensor_update"]
                     + files_launches["multi_tensor_update"]),
        "max_abs_err": u1_summary["max_abs_err"],
        **{key: u1_a[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}})
    # U1's sixth formula, mp_adam: one update of ResNet-50's bf16 weights
    # with f32 masters (phase 21a); its launches are the breadth path's
    # ResNet-50 steps (28b)
    u1_c = u1_summary["timed"]["c"]
    kernels.append({
        "name": "multi_tensor_update.mp_adam", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/multi_tensor_update.cu",
        "replaces": "mxnet_tpu/optimizer.py:666",
        "launches": breadth["mp_adam_launches"],
        "max_abs_err": u1_summary["max_abs_err_by_formula"]["mp_adam"],
        **{key: u1_c[key] for key in ("ms", "plain_ms", "bound_ms",
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
    # S1: the example's push (1M x 32 table, 192 rows), lazy Adam, f32
    s1_main = next(r for r in s1_summary["timed"] if r["formula"] == "adam"
                   and r["shape"] == S1_SHAPES[0])
    kernels.append({
        "name": "sparse_row_update", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/sparse_row_update.cu",
        "replaces": "mxnet_tpu/optimizer.py:38",
        "launches": sp_launches["sparse_row_update"],
        "max_abs_err": s1_summary["max_abs_err"],
        **{key: s1_main[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}})
    log("script seconds %.1f" % (time.perf_counter() - script_t0))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit({"--speech-profile": speech_profile_main,
              "--lstm-profile": lstm_profile_main,
              "--gluon-files": gluon_files_main,
              "--observability": observability_main,
              "--serving": serving_main,
              "--observability-telemetry": observability_telemetry_main,
              "--breadth": breadth_main,
              }.get(" ".join(sys.argv[1:]), main)())
