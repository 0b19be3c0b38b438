"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

The nd core's ops (`mxnet_tpu_torch/tools/op_sweep.py`) run on the card
against the CPU, each held to its family's limit, with the families'
controls; Dropout's statistics and a hybridized net holding Dropout, and
an example run through `tools/run_example.py` under ``gpu(0)``.

Each section states its tolerances. The LSTM kernels: 1e-4, f32 on both
sides, but the kernels sum h @ Wh (and dgates @ Wh^T) in another order
than cuBLAS, and the difference compounds over time. One train step of
the LM on the card against the same step on the CPU is held to 1e-4 too:
both run f32 with TF32 off.
"""
import gc
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops import lstm_kernel
from mxnet_tpu_torch.ops.lstm_kernel import (
    FusedLSTM, fused_lstm, fused_lstm_backward_plain, fused_lstm_plain,
    fused_lstm_train, fused_lstm_train_plain, lstm_bwd_recurrence,
    lstm_bwd_recurrence_plain)
from mxnet_tpu_torch.ops.nn import rnn_param_size
from mxnet_tpu_torch.ops.registry import get_op

TOL = 1e-4
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(t, b, i, h, device, seed=0):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(t, b, i), rng.randn(b, h), rng.randn(b, h),
              rng.randn(i, 4 * h) * 0.1, rng.randn(h, 4 * h) * 0.1,
              rng.randn(4 * h) * 0.1]
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in arrays]


@pytest.mark.parametrize("shape", [(5, 4, 6, 8), (4, 1, 5, 13),
                                   (3, 9, 7, 33), (35, 32, 650, 650)])
def test_kernel_matches_plain(cuda, shape):
    args = _inputs(*shape, device=cuda)
    before = fused_lstm.launches
    got = fused_lstm(*args)
    want = fused_lstm_plain(*args)
    torch.cuda.synchronize()
    assert fused_lstm.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_rnn_op_on_cuda_matches_cpu(cuda, bidirectional):
    # the reverse direction runs the kernel over the flipped sequence
    t, b, i, h, layers = 6, 3, 5, 7, 2
    d = 2 if bidirectional else 1
    rng = np.random.RandomState(1)
    n = rnn_param_size(layers, i, h, bidirectional, "lstm")
    arrays = [rng.randn(t, b, i), rng.randn(n) * 0.3,
              rng.randn(layers * d, b, h), rng.randn(layers * d, b, h)]
    cpu = [torch.from_numpy(a.astype(np.float32)) for a in arrays]
    params = {"mode": "lstm", "state_size": h, "num_layers": layers,
              "bidirectional": bidirectional, "state_outputs": True,
              "_is_train": False, "_generator": None}
    before = fused_lstm.launches
    got = get_op("RNN").fcompute(dict(params), *[a.to(cuda) for a in cpu])
    assert fused_lstm.launches == before + layers * d
    want = get_op("RNN").fcompute(dict(params), *cpu)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=TOL, atol=TOL)


def test_rejects_tensors_on_two_devices(cuda):
    args = _inputs(2, 2, 3, 4, device=cuda)
    args[4] = args[4].cpu()
    with pytest.raises(mxt.MXNetError, match="wh is on cpu"):
        fused_lstm(*args)


SHAPES = [(5, 4, 6, 8), (4, 1, 5, 13), (3, 9, 7, 33), (35, 32, 650, 650)]
# K1 and K2 at the rest of chip_smoke.py's shapes: B = 3 and 64, T = 1,
# batches walked in two row tiles (the persistent route holds at most 64
# rows of h), and one whose Wh slice does not fit (the step route)
ROUTE_SHAPES = [((35, 3, 650, 650), "persistent"),
                ((1, 32, 650, 650), "persistent"),
                ((35, 64, 650, 650), "persistent"),
                ((3, 100, 16, 650), "persistent"),
                ((4, 70, 5, 13), "persistent"),
                ((8, 4, 64, 1536), "step")]


@pytest.mark.parametrize("shape,route", ROUTE_SHAPES)
@pytest.mark.parametrize("kernel", ["fused_lstm", "fused_lstm_train"])
def test_forward_routes_match_plain(cuda, kernel, shape, route):
    wrapper, plain = {"fused_lstm": (fused_lstm, fused_lstm_plain),
                      "fused_lstm_train": (fused_lstm_train,
                                           fused_lstm_train_plain)}[kernel]
    t, b, i, h = shape
    assert lstm_kernel.lstm_plan(b, h, cuda).route == route
    args = _inputs(*shape, device=cuda, seed=5)
    before = wrapper.launches_by_route[route]
    got = wrapper(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert wrapper.launches_by_route[route] == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kernel", ["fused_lstm", "fused_lstm_train"])
def test_forward_is_bitwise_deterministic(cuda, kernel):
    # every sum runs in a fixed order: a missing fence or an early barrier
    # would show as a difference between calls
    wrapper = getattr(lstm_kernel, kernel)
    args = _inputs(35, 32, 650, 650, device=cuda, seed=6)
    first = [o.clone() for o in wrapper(*args)]
    for _ in range(19):
        for g, w in zip(wrapper(*args), first):
            assert torch.equal(g, w)


@pytest.mark.parametrize("plan", [
    # more shared memory than a block may have
    lstm_kernel.LSTMPlan("persistent", 130, 5, 32, 300000),
    # 650 blocks of one unit, one a SM: more than the card holds at once
    lstm_kernel.LSTMPlan("persistent", 650, 1, 32, 200000),
    # a plan that leaves units without a block
    lstm_kernel.LSTMPlan("persistent", 100, 5, 32, 135616)])
def test_refused_plan_raises(cuda, monkeypatch, plan):
    monkeypatch.setattr(lstm_kernel, "_lstm_route", lambda *a: plan)
    args = _inputs(3, 32, 8, 650, device=cuda)
    before = fused_lstm.launches
    with pytest.raises(mxt.MXNetError, match="kernel launch failed"):
        fused_lstm(*args)
    assert fused_lstm.launches == before


def _cotangents(t, b, h, device, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(device)
            for s in ((t, b, h), (b, h), (b, h))]


@pytest.mark.parametrize("shape", SHAPES)
def test_train_forward_matches_plain(cuda, shape):
    args = _inputs(*shape, device=cuda)
    before = fused_lstm_train.launches
    got = fused_lstm_train(*args)
    want = fused_lstm_train_plain(*args)
    torch.cuda.synchronize()
    assert fused_lstm_train.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_recurrence_matches_plain(cuda, shape):
    t, b, i, h = shape
    x, h0, c0, wx, wh, bias = _inputs(*shape, device=cuda)
    _, cseq, gates = fused_lstm_train_plain(x, h0, c0, wx, wh, bias)
    dhseq, dhn, dcn = _cotangents(t, b, h, cuda, seed=3)
    before = lstm_bwd_recurrence.launches
    got = lstm_bwd_recurrence(dhseq, dhn, dcn, gates, cseq, c0, wh)
    want = lstm_bwd_recurrence_plain(dhseq, dhn, dcn, gates, cseq, c0, wh)
    torch.cuda.synchronize()
    assert lstm_bwd_recurrence.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


# K3 by route: the LM's shapes (B = 8, 32, 64; T = 1), a ragged small shape
# (H and B off every tile size), batches walked in row tiles (100 rows at
# H = 650; 32 rows in 8-row tiles at H = 1100, 9 units a block, the most
# the kernel is built for) and one whose Wh slice does not fit (the step
# route)
BWD_ROUTE_SHAPES = [((35, 8, 650, 650), "persistent"),
                    ((35, 32, 650, 650), "persistent"),
                    ((35, 64, 650, 650), "persistent"),
                    ((1, 32, 650, 650), "persistent"),
                    ((5, 3, 7, 13), "persistent"),
                    ((3, 100, 16, 650), "persistent"),
                    ((4, 32, 8, 1100), "persistent"),
                    ((8, 4, 64, 1536), "step")]


def _bwd_args(shape, device, seed, transposed=False):
    """K3's inputs from K2's plain forward; with ``transposed`` Wh is the
    (H, 4H) view of a contiguous (4H, H) tensor, as the RNN op passes it."""
    t, b, i, h = shape
    x, h0, c0, wx, wh, bias = _inputs(*shape, device=device, seed=seed)
    _, cseq, gates = fused_lstm_train_plain(x, h0, c0, wx, wh, bias)
    if transposed:
        wh = wh.t().contiguous().t()
    return (*_cotangents(t, b, h, device, seed=seed + 1), gates, cseq, c0,
            wh)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("shape,route", BWD_ROUTE_SHAPES)
def test_backward_routes_match_plain(cuda, shape, route, transposed):
    t, b, i, h = shape
    plan = lstm_kernel.lstm_bwd_plan(b, h, cuda)
    assert plan.route == route
    args = _bwd_args(shape, cuda, seed=7, transposed=transposed)
    before = dict(lstm_bwd_recurrence.launches_by_route)
    got = lstm_bwd_recurrence(*args)
    want = lstm_bwd_recurrence_plain(*args)
    torch.cuda.synchronize()
    assert lstm_bwd_recurrence.launches_by_route == {
        r: n + (r == route) for r, n in before.items()}
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


def test_backward_is_bitwise_deterministic(cuda):
    # a fixed order of every sum: the product over the block's columns,
    # then the writers in order; a missing fence would show here
    args = _bwd_args((35, 32, 650, 650), cuda, seed=8, transposed=True)
    first = [o.clone() for o in lstm_bwd_recurrence(*args)]
    for _ in range(19):
        for g, w in zip(lstm_bwd_recurrence(*args), first):
            assert torch.equal(g, w)


@pytest.mark.parametrize("plan", [
    # more shared memory than a block may have
    lstm_kernel.LSTMPlan("persistent", 130, 5, 32, 300000),
    # shared memory short of what the plan's tile needs
    lstm_kernel.LSTMPlan("persistent", 130, 5, 32, 100000),
    # 650 blocks of one unit, one a SM: more than the card holds at once
    lstm_kernel.LSTMPlan("persistent", 650, 1, 8, 200000),
    # a plan that leaves units without a block
    lstm_kernel.LSTMPlan("persistent", 100, 5, 32, 137760),
    # a unit count the kernel is not built for
    lstm_kernel.LSTMPlan("persistent", 65, 10, 8, 200000)])
def test_refused_backward_plan_raises(cuda, monkeypatch, plan):
    monkeypatch.setattr(lstm_kernel, "_lstm_bwd_route", lambda *a: plan)
    args = _bwd_args((3, 32, 8, 650), cuda, seed=9)
    before = dict(lstm_bwd_recurrence.launches_by_route)
    with pytest.raises(mxt.MXNetError, match="kernel launch failed"):
        lstm_bwd_recurrence(*args)
    assert lstm_bwd_recurrence.launches_by_route == before


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_fused_lstm_gradients_match_plain(cuda, shape):
    t, b, i, h = shape
    args = [a.requires_grad_(True) for a in _inputs(*shape, device=cuda)]
    cots = _cotangents(t, b, h, cuda, seed=4)
    outs = FusedLSTM.apply(*args)
    got = torch.autograd.grad(outs, args, cots)
    with torch.no_grad():
        hseq, cseq, gates = fused_lstm_train_plain(*args)
        want = fused_lstm_backward_plain(*cots, args[0], args[1], args[2],
                                         args[3], args[4], hseq, cseq,
                                         gates)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


def _lm(mx, ctx, t, b, vocab, hidden):
    data = mx.sym.var("data")
    x = mx.sym.Embedding(data, input_dim=vocab, output_dim=hidden,
                         name="embed")
    x = mx.sym.RNN(x, state_size=hidden, num_layers=2, mode="lstm",
                   name="lstm")
    x = mx.sym.FullyConnected(mx.sym.Reshape(x, shape=(-1, hidden)),
                              num_hidden=vocab, name="decoder")
    mod = mx.mod.Module(mx.sym.SoftmaxOutput(x, name="softmax"),
                        context=ctx)
    mod.bind(data_shapes=[("data", (t, b))],
             label_shapes=[("softmax_label", (t * b,))])
    mx.random.seed(0)
    mod.init_params(initializer=mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 1.0, "clip_gradient": 0.25})
    return mod


def test_module_step_on_gpu_matches_cpu(cuda):
    t, b, vocab, hidden = 6, 5, 40, 24
    rng = np.random.RandomState(5)
    batch = mxt.io.DataBatch(
        data=[mxt.nd.array(rng.randint(0, vocab, (t, b)))],
        label=[mxt.nd.array(rng.randint(0, vocab, t * b))])
    mods = [_lm(mxt, ctx, t, b, vocab, hidden)
            for ctx in (mxt.gpu(0), mxt.cpu())]
    before = (fused_lstm_train.launches, lstm_bwd_recurrence.launches)
    persistent = lstm_bwd_recurrence.launches_by_route["persistent"]
    for mod in mods:
        mod._step(batch)
    assert (fused_lstm_train.launches, lstm_bwd_recurrence.launches) == \
        (before[0] + 2, before[1] + 2)
    # K3 takes its one-launch route, once a layer
    assert lstm_bwd_recurrence.launches_by_route["persistent"] == \
        persistent + 2
    got, want = (m.get_outputs()[0].asnumpy() for m in mods)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for name, arr in mods[0].get_params()[0].items():
        np.testing.assert_allclose(arr.asnumpy(),
                                   mods[1].get_params()[0][name].asnumpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)


# ---------------------------------------------------------------------------
# K5 (conv1x1_s2_dgrad) and the ResNet path on the card
# ---------------------------------------------------------------------------
# gradients and updates, card vs CPU, by relative norm (see the test): on
# an H100 the readings were at most 0.0375, and a zeroed gradient or
# update reads 1.0; the limit is about their geometric mean
SMALL_RESNET_REL = 0.2
# small shapes, the six stride-2 sites of a ResNet-50 step at batch 8, and
# bf16 shapes the WMMA route takes (K or C not a multiple of 8)
K5_SITES_B8 = [(8, ho, ho, k, c) for ho, c in ((28, 256), (14, 512),
                                               (7, 1024))
               for k in (c // 2, 2 * c)]
K5_WMMA_SHAPES = [(4, 7, 7, 60, 100), (3, 5, 3, 40, 134)]
K5_SHAPES = ([(2, 3, 5, 128, 256), (3, 5, 3, 40, 136), (2, 7, 7, 512, 128),
              (1, 1, 1, 8, 8)] + K5_SITES_B8 + K5_WMMA_SHAPES)


def _k5_inputs(shape, dtype, device, seed=7):
    n, ho, wo, k, c = shape
    rng = np.random.RandomState(seed)
    dy = torch.from_numpy(rng.randn(n, ho, wo, k).astype(np.float32)) \
        .to(device, dtype)
    w2 = torch.from_numpy((rng.randn(k, c) / np.sqrt(k)).astype(np.float32)) \
        .to(device, dtype)
    return dy, w2


def _k5_check(got, dy, w2):
    from mxnet_tpu_torch.ops.conv_kernel import conv1x1_s2_dgrad_plain
    want = conv1x1_s2_dgrad_plain(dy, w2, got.shape[1], got.shape[2])
    torch.cuda.synchronize()
    # bf16: both round an f32 sum, in another order, to 8 significant bits
    tol = TOL if dy.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert bool((got[:, 1::2] == 0).all()) and \
        bool((got[:, :, 1::2] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K5_SHAPES)
def test_k5_matches_plain(cuda, shape, dtype):
    from mxnet_tpu_torch.ops.conv_kernel import (conv1x1_s2_dgrad,
                                                 conv1x1_s2_dgrad_plan)
    n, ho, wo, k, c = shape
    dy, w2 = _k5_inputs(shape, dtype, cuda)
    plan = conv1x1_s2_dgrad_plan(dy, w2)
    assert plan.route == ("f32" if dtype == torch.float32 else
                          "wmma" if shape in K5_WMMA_SHAPES else "wgmma")
    before = dict(conv1x1_s2_dgrad.launches_by_route)
    launches = conv1x1_s2_dgrad.launches
    got = conv1x1_s2_dgrad(dy, w2, 2 * ho, 2 * wo)
    assert conv1x1_s2_dgrad.launches == launches + 1
    before[plan.route] += 1
    assert conv1x1_s2_dgrad.launches_by_route == before
    _k5_check(got, dy, w2)


@pytest.mark.parametrize("bn", [128, 256])
@pytest.mark.parametrize("shape", [(2, 3, 5, 128, 256), (3, 5, 3, 40, 136),
                                   (8, 14, 14, 1024, 512),
                                   (8, 7, 7, 512, 1024)])
def test_k5_both_tile_widths_match_plain(cuda, monkeypatch, shape, bn):
    # the wgmma route's two kernels, whichever width the plan would take
    from mxnet_tpu_torch.ops import conv_kernel
    route = conv_kernel._k5_route

    def width(n, ho, wo, k, c, dtype, sms):
        plan = route(n, ho, wo, k, c, dtype, sms)
        return conv_kernel._wgmma_plan(plan.row_tiles, c, bn, sms)
    monkeypatch.setattr(conv_kernel, "_k5_route", width)
    n, ho, wo, k, c = shape
    dy, w2 = _k5_inputs(shape, torch.bfloat16, cuda, seed=8)
    assert conv_kernel.conv1x1_s2_dgrad_plan(dy, w2).bn == bn
    _k5_check(conv_kernel.conv1x1_s2_dgrad(dy, w2, 2 * ho, 2 * wo), dy, w2)


def test_k5_is_bitwise_deterministic(cuda):
    # each element is one thread's sum over K in a fixed order
    from mxnet_tpu_torch.ops.conv_kernel import conv1x1_s2_dgrad
    dy, w2 = _k5_inputs((8, 28, 28, 512, 256), torch.bfloat16, cuda, seed=9)
    first = conv1x1_s2_dgrad(dy, w2, 56, 56)
    for _ in range(19):
        assert torch.equal(conv1x1_s2_dgrad(dy, w2, 56, 56), first)


def test_k5_takes_unaligned_views(cuda):
    # TMA needs 16-byte aligned operands: the wrapper copies a view that
    # is not
    from mxnet_tpu_torch.ops.conv_kernel import conv1x1_s2_dgrad
    dy, w2 = _k5_inputs((2, 3, 5, 128, 256), torch.bfloat16, cuda, seed=10)
    flat = torch.empty(dy.numel() + 1, dtype=dy.dtype, device=cuda)
    flat[1:] = dy.reshape(-1)
    view = flat[1:].view(dy.shape)
    assert view.data_ptr() % 16 != 0
    _k5_check(conv1x1_s2_dgrad(view, w2, 6, 10), dy, w2)


def _k5_plan(route, bn, stages, grid, smem, rows=1, cols=1):
    from mxnet_tpu_torch.ops.conv_kernel import K5Plan
    return K5Plan(route, bn, stages, grid, rows, cols, smem)


@pytest.mark.parametrize("shape,plan", [
    # a tile width the kernel is not built for
    ((2, 3, 5, 128, 256), _k5_plan("wgmma", 192, 3, 1, 216128)),
    # shared memory or ring depth other than the kernel's layout
    ((2, 3, 5, 128, 256), _k5_plan("wgmma", 256, 3, 1, 300000)),
    ((2, 3, 5, 128, 256), _k5_plan("wgmma", 256, 4, 1, 216128)),
    # no blocks, or more blocks than tiles
    ((2, 3, 5, 128, 256), _k5_plan("wgmma", 256, 3, 0, 216128)),
    ((2, 3, 5, 128, 256), _k5_plan("wgmma", 256, 3, 2, 216128)),
    # K not a multiple of 8 on the TMA route
    ((2, 3, 5, 60, 256), _k5_plan("wgmma", 256, 3, 1, 216128)),
    # the f32 route for bf16, and a WMMA grid that misses tiles
    ((2, 3, 5, 128, 256), _k5_plan("f32", 64, 1, 4, 0, 1, 4)),
    ((2, 3, 5, 128, 256), _k5_plan("wmma", 64, 1, 3, 0, 1, 3))])
def test_k5_refused_plan_raises(cuda, monkeypatch, shape, plan):
    from mxnet_tpu_torch.ops import conv_kernel
    monkeypatch.setattr(conv_kernel, "_k5_route", lambda *a: plan)
    n, ho, wo, k, c = shape
    dy, w2 = _k5_inputs(shape, torch.bfloat16, cuda, seed=11)
    before = (conv_kernel.conv1x1_s2_dgrad.launches,
              dict(conv_kernel.conv1x1_s2_dgrad.launches_by_route))
    with pytest.raises(mxt.MXNetError, match="kernel launch failed"):
        conv_kernel.conv1x1_s2_dgrad(dy, w2, 2 * ho, 2 * wo)
    assert (conv_kernel.conv1x1_s2_dgrad.launches,
            conv_kernel.conv1x1_s2_dgrad.launches_by_route) == before


def test_k5_refuses_what_it_cannot_launch(cuda):
    from mxnet_tpu_torch.ops.conv_kernel import conv1x1_s2_dgrad
    dy = torch.zeros(1, 2, 2, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(mxt.MXNetError, match="f32 or bf16"):
        conv1x1_s2_dgrad(dy, torch.zeros(8, 4, device=cuda,
                                          dtype=torch.float16), 4, 4)
    with pytest.raises(mxt.MXNetError, match="w2 is on cpu"):
        conv1x1_s2_dgrad(dy.float(), torch.zeros(8, 4), 4, 4)


def _small_resnet_module(ctx, weights):
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                        ResNetV1)
    net = ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 128, 256, 384, 512],
                   classes=10, layout="NHWC", prefix="net_")
    net.initialize(mxt.init.Xavier(), ctx=ctx)
    net(mxt.nd.zeros((2, 64, 64, 3), ctx=ctx))
    sym = mxt.sym.SoftmaxOutput(net._trace_symbol(), name="softmax")
    mod = mxt.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", (2, 64, 64, 3))],
             label_shapes=[("softmax_label", (2,))])
    if weights is None:     # He-normal weights, seeded
        rng = np.random.RandomState(3)
        weights = {}
        shapes = dict(zip(sym.list_arguments(),
                          sym.infer_shape(data=(2, 64, 64, 3))[0]))
        for name in mod._param_names:
            s = shapes[name]
            weights[name] = (rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
                             if name.endswith("weight") else
                             rng.uniform(0.5, 1.5, s) if name.endswith("gamma")
                             else rng.randn(*s) * 0.1).astype(np.float32)
    mod.init_params(arg_params=weights)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.05, "momentum": 0.9})
    return mod, weights


def _worst_rel(got, want):
    """The largest |got - want| / |want| (Frobenius) over {name: array}."""
    worst = 0.0
    for name, w in want.items():
        num, den = np.linalg.norm(got[name] - w), np.linalg.norm(w)
        worst = max(worst, num / den if den else (0.0 if num == 0 else np.inf))
    return float(worst)


def test_small_resnet_steps_on_gpu_match_cpu(cuda, monkeypatch):
    """Two SGD-momentum steps (lr 0.05) of the small NHWC ResNet (the CPU
    parity test's net) with the gate on: K5 six times a step on the card,
    the plain version on the CPU. f32 both sides, TF32 off, each step from
    the card's weights. After ``forward_backward`` the outputs and moving
    statistics are held elementwise to rtol 1e-4, atol 1e-5; every
    parameter's gradient, and after ``update`` its change, by relative
    norm |g - g_cpu| / |g_cpu| to SMALL_RESNET_REL. A ReLU input within
    ~1e-6 of zero can change sides with the summation order and move its
    layer's gradient by a few percent; a missing, zeroed or sign-flipped
    gradient or update reads 1 or more. The readings are printed (``-s``)."""
    from mxnet_tpu_torch.ops.conv_kernel import conv1x1_s2_dgrad
    monkeypatch.setenv("MXNET_CONV1X1_PALLAS", "1")
    torch.backends.cudnn.allow_tf32 = False
    gpu_mod, weights = _small_resnet_module(mxt.gpu(0), None)
    cpu_mod, _ = _small_resnet_module(mxt.cpu(), weights)
    rng = np.random.RandomState(4)
    before = conv1x1_s2_dgrad.launches
    readings = []
    for _ in range(2):
        batch = mxt.io.DataBatch(
            data=[mxt.nd.array(rng.rand(2, 64, 64, 3))],
            label=[mxt.nd.array(rng.randint(0, 10, 2))])
        cpu_mod.set_params(*[mxt.params_to_numpy(d)
                             for d in gpu_mod.get_params()])
        start = mxt.params_to_numpy(cpu_mod.get_params()[0])
        for mod in (gpu_mod, cpu_mod):
            mod.forward_backward(batch)
        got, want = (m.get_outputs()[0].asnumpy() for m in (gpu_mod,
                                                            cpu_mod))
        np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-5)
        for name, arr in cpu_mod.get_params()[1].items():
            np.testing.assert_allclose(gpu_mod.get_params()[1][name].asnumpy(),
                                       arr.asnumpy(), rtol=TOL, atol=1e-5,
                                       err_msg=name)
        grads = [{n: m._exec.grad_dict[n].asnumpy() for n in m._param_names}
                 for m in (gpu_mod, cpu_mod)]
        for mod in (gpu_mod, cpu_mod):
            mod.update()
        moved = [{n: v - start[n] for n, v in
                  mxt.params_to_numpy(m.get_params()[0]).items()}
                 for m in (gpu_mod, cpu_mod)]
        readings.append((_worst_rel(*grads), _worst_rel(*moved)))
    torch.cuda.synchronize()
    print("small ResNet gradient and update relative errors", readings)
    assert conv1x1_s2_dgrad.launches == before + 12
    assert max(max(r) for r in readings) <= SMALL_RESNET_REL, readings


# ---------------------------------------------------------------------------
# K4 (flash_attention) and rtc on the card
# ---------------------------------------------------------------------------
# (B, Tq, Tk, H, D): bf16 tiles of 128 q rows (64 a consumer warpgroup) and
# 128 keys, f32 tiles of 32 rows and 64 keys; Tq and Tk at every tile edge
# (1, 63, 64, 65, 127, 128, 129, 255), Tq != Tk both ways (the causal mask
# is aligned at the top left); D below a 64-column TMA box (8, 40), across
# two (96), and 7, which the wrapper pads to 8; B*H = 150 blocks of q rows
# twice over, more than the card's 132 SMs
K4_SHAPES = [(1, 128, 128, 2, 64), (2, 200, 200, 3, 128), (1, 100, 300, 2, 64),
             (2, 300, 100, 2, 128), (1, 77, 77, 1, 40),
             (1, 1, 129, 2, 128), (1, 129, 1, 2, 128), (1, 63, 255, 2, 64),
             (1, 255, 63, 2, 64), (2, 65, 127, 1, 96), (2, 127, 65, 1, 96),
             (1, 64, 128, 2, 8), (1, 128, 64, 2, 40), (1, 255, 129, 1, 7),
             (3, 129, 129, 50, 64)]
# f32: the reference's 2e-5; bf16: both sides compute in f32 and round once
# to bf16, so a value may land one bf16 step (2^-7 relative) apart
K4_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2 ** -7, 1e-5)}


def _attention_inputs(shape, device, dtype, seed=0):
    b, tq, tk, h, d = shape
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32))
            .to(device, dtype) for t in (tq, tk, tk)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K4_SHAPES)
def test_k4_matches_plain(cuda, shape, dtype, causal):
    from mxnet_tpu_torch.ops.attention_kernel import (flash_attention,
                                                      flash_attention_plain)
    q, k, v = _attention_inputs(shape, cuda, dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = K4_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_k4_given_scale_and_strided_inputs(cuda):
    from mxnet_tpu_torch.ops.attention_kernel import (flash_attention,
                                                      flash_attention_plain)
    q, k, v = _attention_inputs((2, 96, 96, 2, 64), cuda, torch.float32, 1)
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)   # not contiguous
    got = flash_attention(qs, k, v, scale=0.3, causal=True)
    want = flash_attention_plain(q, k, v, scale=0.3, causal=True)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_k4_unaligned_bf16_inputs(cuda, causal):
    """q, k, v views that start 2 bytes past a 16-byte boundary: the
    wrapper copies them for the TMA maps, and the result is the plain
    version's on the same values."""
    from mxnet_tpu_torch.ops.attention_kernel import (flash_attention,
                                                      flash_attention_plain)
    shape = (2, 100, 130, 2, 64)
    want_in = _attention_inputs(shape, cuda, torch.bfloat16, 5)
    views = []
    for t in want_in:
        buf = torch.empty(t.numel() + 1, device=cuda, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 2
        views.append(view)
    before = flash_attention.launches
    got = flash_attention(*views, causal=causal)
    want = flash_attention_plain(*want_in, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    rtol, atol = K4_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_k4_refuses_what_it_cannot_launch(cuda):
    from mxnet_tpu_torch.ops.attention_kernel import _library, flash_attention
    q = torch.zeros(1, 4, 1, 256, device=cuda)
    with pytest.raises(mxt.MXNetError, match="head dims up to 128"):
        flash_attention(q, q, q)
    h = torch.zeros(1, 4, 1, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(mxt.MXNetError, match="f32 or bf16"):
        flash_attention(h, h, h)
    with pytest.raises(mxt.MXNetError, match="k on cpu"):
        flash_attention(h.float(), h.float().cpu(), h.float())
    # the launcher itself refuses what its TMA maps cannot address: an
    # unaligned pointer, a bf16 head dim that is not a multiple of 8
    lib = _library()
    b = torch.zeros(64, device=cuda, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    for ptr, d in ((b.data_ptr() + 2, 8), (b.data_ptr(), 7)):
        err = lib.flash_attention_fwd(ptr, b.data_ptr(), b.data_ptr(),
                                      b.data_ptr(), 1, 4, 4, 1, d, 1.0, 0, 1,
                                      stream)
        assert err == -3, err
        assert b"TMA" in lib.flash_attention_error_name(err)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_backward_on_card(cuda, causal):
    from mxnet_tpu_torch.ops.attention_kernel import (FlashAttention,
                                                      dense_attention_plain,
                                                      flash_attention)
    q, k, v = (t.requires_grad_(True) for t in _attention_inputs(
        (2, 150, 150, 2, 64), cuda, torch.float32, 2))
    cot = torch.from_numpy(np.random.RandomState(3).randn(
        2, 150, 2, 64).astype(np.float32)).to(cuda)
    before = flash_attention.launches
    got = torch.autograd.grad(FlashAttention.apply(q, k, v, None, causal),
                              (q, k, v), cot)
    assert flash_attention.launches == before + 1
    want = torch.autograd.grad(dense_attention_plain(q, k, v, None, causal),
                               (q, k, v), cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


AXPY = r'''
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


def test_rtc_axpy_and_exported_template(cuda):
    from mxnet_tpu_torch import rtc
    mod = rtc.CudaModule(AXPY, exports=["axpy", "row_sum<float>"])
    axpy = mod.get_kernel("axpy", "const float *x, const float *y, "
                                  "float *out, int n")
    rng = np.random.RandomState(4)
    n = 1000
    x, y = (mxt.nd.array(rng.randn(n), ctx=mxt.gpu(0)) for _ in range(2))
    out = mxt.nd.zeros((n,), ctx=mxt.gpu(0))
    before = rtc.Kernel.launches
    assert axpy.launch((x, y, out, n), mxt.gpu(0), (4, 1, 1),
                       (256, 1, 1)) is None
    torch.cuda.synchronize()
    assert rtc.Kernel.launches == before + 1
    assert torch.equal(out.data, 2 * x.data + y.data)
    rows = mod.get_kernel("row_sum<float>",
                          "const float *x, int cols, float *out")
    m = mxt.nd.array(rng.randn(37, 300), ctx=mxt.gpu(0))
    got = rows.launch((m, 300), mxt.gpu(0), (37,), (128,),
                      shared_mem=128 * 4, out_shapes=[((37,), "float32")])
    torch.testing.assert_close(got.data, m.data.sum(1), rtol=1e-5,
                               atol=1e-5)


def test_rtc_raises(cuda):
    from mxnet_tpu_torch import rtc
    mod = rtc.CudaModule(AXPY, exports=["row_sum<float>"])
    with pytest.raises(ValueError, match="not in exports"):
        mod.get_kernel("row_sum<double>", "const double *x, int cols, "
                                          "double *out")
    with pytest.raises(ValueError, match="not in exports"):   # as in JAX
        mod.get_kernel("axpy", "const float *x, const float *y, "
                               "float *out, int n")
    bare = rtc.CudaModule(AXPY)
    with pytest.raises(ValueError, match="no kernel 'scale'"):
        bare.get_kernel("scale", "float *x")
    axpy = bare.get_kernel("axpy", "const float *x, const float *y, "
                                   "float *out, int n")
    x = mxt.nd.zeros((8,), ctx=mxt.gpu(0), dtype="float64")
    with pytest.raises(mxt.MXNetError, match="must be torch.float32"):
        axpy.launch((x, x, x, 8), mxt.gpu(0), (1,), (8,))
    with pytest.raises(mxt.MXNetError, match="could not compile"):
        rtc.CudaModule('extern "C" __global__ void k() { undefined(); }')


# ---------------------------------------------------------------------------
# hybridize on the card: one captured CUDA graph per input signature
# (compiled.py). f32 with TF32 off in cuDNN and cuBLAS; the graph replays
# the eager path's kernels, so outputs agree with the eager call to 1e-5.
# ---------------------------------------------------------------------------
HYB_TOL = 1e-5


@pytest.fixture
def f32(cuda):
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32 = saved


def _small_net(prefix):
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
                nn.BatchNorm(in_channels=8), nn.Activation("relu"),
                nn.GlobalAvgPool2D(), nn.Dense(4, in_units=8))
    net.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0))
    return net


def _image(seed, batch=2):
    return mxt.nd.array(np.random.RandomState(seed).rand(batch, 3, 16, 16),
                        ctx=mxt.gpu(0))


def _moving(net):
    return {n: p.data().data.clone() for n, p in net.collect_params().items()
            if "running" in n}


def test_hybridized_call_is_a_graph_replay(f32):
    from mxnet_tpu_torch import compiled
    net = _small_net("cap_")
    x = _image(0)
    eager = net(x).data
    net.hybridize()
    compiled.reset()
    first = net(x)
    second = net(x)
    assert compiled.compile_counts() == {"compiles": 1, "cache_hits": 1,
                                         "retraces": 0, "uncaptured": 0}
    assert first.data.device.type == "cuda"
    (entry,) = net._cached_jit._cache.values()
    assert isinstance(entry, compiled._Graph)
    torch.testing.assert_close(first.data, eager, rtol=HYB_TOL, atol=HYB_TOL)
    assert torch.equal(first.data, second.data)
    net(_image(1, batch=3))
    assert "dim 0: 2 -> 3" in compiled.last_retrace()["reason"]


def test_tf32_switch_recaptures(f32):
    """A graph keeps the convolution kernels chosen at its capture, so
    turning cuDNN's TF32 on is a new signature: the replay then matches
    the eager call under TF32, not the f32 graph."""
    from mxnet_tpu_torch import compiled
    net = _small_net("tf32_")
    x = _image(7)
    net.hybridize()
    f32_out = net(x).data
    torch.backends.cudnn.allow_tf32 = True
    got = net(x).data
    assert compiled.last_retrace()["reason"].startswith("tf32 (cudnn")
    torch.testing.assert_close(got, net._forward_impl(x).data, rtol=1e-3,
                               atol=1e-3)
    torch.backends.cudnn.allow_tf32 = False
    assert torch.equal(net(x).data, f32_out)


class _GcProbe(mxt.gluon.HybridBlock):
    seen = []

    def hybrid_forward(self, F, x):
        if torch.cuda.is_current_stream_capturing():
            _GcProbe.seen.append(gc.isenabled())
        return x * 2.0


def test_collector_is_off_during_a_capture(f32):
    """A collection inside a capture could free a dropped program's graph
    memory, which invalidates the capture (seen as a cuBLAS failure in
    the next product): the collector is off while capturing, and on
    again after."""
    assert gc.isenabled()
    net = _GcProbe()
    net.hybridize()
    x = _image(8)
    assert torch.equal(net(x).data, x.data * 2.0)
    assert _GcProbe.seen == [False]
    assert gc.isenabled()


def test_replay_returns_clones(f32):
    net = _small_net("clone_")
    net.hybridize()
    a = net(_image(0))
    kept = a.data.clone()
    b = net(_image(1))
    torch.cuda.synchronize()
    assert torch.equal(a.data, kept)
    assert not torch.equal(a.data, b.data)
    assert a.data.data_ptr() != b.data.data_ptr()


def test_parameter_updates_reach_the_graph(f32):
    """``set_data`` writes into the tensor the graph reads: the next
    replay uses it without a recapture. A re-initialisation moves the
    storage: one recapture, reported as a retrace naming the weight."""
    from mxnet_tpu_torch import compiled
    net = _small_net("upd_")
    net.hybridize()
    x = _image(2)
    net(x)
    w = net.collect_params()["upd_conv0_weight"]
    w.set_data(np.full(w.shape, 0.05, np.float32))
    counts = compiled.compile_counts()
    got = net(x).data
    assert compiled.compile_counts()["compiles"] == counts["compiles"]
    torch.testing.assert_close(got, net._forward_impl(x).data, rtol=HYB_TOL,
                               atol=HYB_TOL)
    net.collect_params().initialize(mxt.init.Xavier(), ctx=mxt.gpu(0),
                                    force_reinit=True)
    got = net(x).data
    assert compiled.compile_counts()["retraces"] == counts["retraces"] + 1
    assert "arg0[upd_conv0_weight]: storage moved" in \
        compiled.last_retrace()["reason"]
    torch.testing.assert_close(got, net._forward_impl(x).data, rtol=HYB_TOL,
                               atol=HYB_TOL)


class _HostSync(mxt.gluon.HybridBlock):
    def hybrid_forward(self, F, x):
        x.asnumpy()
        return x * 2.0


class _Noisy(mxt.gluon.HybridBlock):
    def hybrid_forward(self, F, x):
        return x + F.random.normal(shape=x.shape, ctx=x.context)


@pytest.mark.parametrize("block,match", [
    (_HostSync, "CUDA graph capture failed"),
    (_Noisy, "draws random numbers")])
def test_capture_that_cannot_work_raises(f32, block, match):
    net = block()
    net.hybridize()
    with pytest.raises(mxt.MXNetError, match=match):
        net(_image(3))
    ok = _small_net("after_")          # the card is usable afterwards
    ok.hybridize()
    assert bool(torch.isfinite(ok(_image(3)).data).all())


def test_warmup_and_train_mode_step_once(f32):
    net = _small_net("bn_")
    x = _image(4, batch=8)
    eager_net = _small_net("bn_")
    for (_, p), (_, q) in zip(sorted(net.collect_params().items()),
                              sorted(eager_net.collect_params().items())):
        q.set_data(p.data().data)
    net.hybridize()
    net(x)
    params = [net.collect_params()[n].data().data for n in net._param_order]
    before = _moving(net)
    net._cached_jit.warmup(params, 0, True, x.data)
    for n, v in _moving(net).items():
        assert torch.equal(v, before[n]), n
    with mxt.autograd.train_mode():
        got = net(x).data
        want = eager_net(x).data
    torch.testing.assert_close(got, want, rtol=HYB_TOL, atol=HYB_TOL)
    after, eager = _moving(net), _moving(eager_net)
    for n, v in after.items():
        assert not torch.equal(v, before[n]), n
        torch.testing.assert_close(v, eager[n], rtol=HYB_TOL, atol=HYB_TOL)


class _Scale(mxt.gluon.HybridBlock):
    def hybrid_forward(self, F, x, s):
        return x * s


def test_scalar_argument_recaptures(f32):
    """A graph keeps the Python scalar it was captured with, so on the
    card a new value is a new signature: one recapture, named in the
    retrace, and each call equals the eager call with its own value. A
    leaf that is neither a tensor nor a scalar cannot be captured."""
    from mxnet_tpu_torch import compiled
    net = _Scale()
    x = _image(11)
    want = {s: net(x, s).data for s in (0.5, 2.0)}
    net.hybridize()
    compiled.reset()
    for s in (0.5, 2.0, 0.5):
        assert torch.equal(net(x, s).data, want[s]), s
    assert compiled.compile_counts() == {"compiles": 2, "cache_hits": 1,
                                         "retraces": 1, "uncaptured": 0}
    assert compiled.last_retrace()["reason"] == \
        "arg4: python float 0.5 -> python float 2.0"
    with pytest.raises(mxt.MXNetError, match=r"arg4\[0\] is opaque NDArray"):
        net(x, [x])


def test_two_threads_share_one_graph(f32):
    net = _small_net("thr_")
    net.hybridize()
    inputs = [_image(10 + i) for i in range(16)]
    want = [net(x).data for x in inputs]
    got = [None] * len(inputs)

    def worker(k):
        for i in range(k, len(inputs), 2):
            got[i] = net(inputs[i]).data
    threads = [threading.Thread(target=worker, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_nd_random_on_the_card(cuda):
    mxt.random.seed(11)
    a = mxt.nd.random.uniform(low=2.0, high=4.0, shape=(40000,))
    assert a.data.device.type == "cuda" and a.context == mxt.gpu(0)
    mxt.random.seed(11)
    b = mxt.nd.random.uniform(low=2.0, high=4.0, shape=(40000,))
    assert torch.equal(a.data, b.data)
    c = mxt.nd.random.uniform(low=2.0, high=4.0, shape=(40000,))
    assert not torch.equal(a.data, c.data)
    x = a.asnumpy()
    assert 2.0 <= x.min() and x.max() <= 4.0
    assert abs(x.mean() - 3.0) <= 0.05
    n = mxt.nd.random.normal(loc=1.5, scale=2.0, shape=(40000,)).asnumpy()
    assert abs(n.mean() - 1.5) <= 0.06 and abs(n.std() - 2.0) <= 0.06
    p = mxt.nd.random.poisson(lam=3.0, shape=(40000,))
    assert p.data.device.type == "cuda"
    assert abs(p.asnumpy().mean() - 3.0) <= 0.15


# ---------------------------------------------------------------------------
# Gluon training on the card: the autograd tape, a hybridized call under
# record() (run eagerly with the tape on: a graph replay carries no
# grad_fn), Trainer and the loss, with K5 under the tape. f32 both sides,
# TF32 off; gradients and updates held as the small ResNet's Module steps
# above, by relative norm to SMALL_RESNET_REL.
# ---------------------------------------------------------------------------
def _small_gluon_net(ctx, layout="NHWC"):
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                        ResNetV1)
    net = ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 128, 256, 384, 512],
                   classes=10, layout=layout, prefix="net_")
    net.initialize(mxt.init.Xavier(), ctx=ctx)
    shape = (4, 32, 32, 3) if layout == "NHWC" else (4, 3, 32, 32)
    net(mxt.nd.zeros(shape, ctx=ctx))
    net.hybridize()
    return net


def _gluon_values(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _gluon_record(net, x, y):
    loss_fn = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    with mxt.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    return loss


def test_gluon_steps_on_gpu_match_cpu(f32, monkeypatch):
    """Two steps of the Gluon loop (SGD momentum 0.9, lr 0.05, wd 1e-4)
    of the small NHWC ResNet with the gate on, each from the card's
    weights: losses and moving statistics elementwise (rtol 1e-4, atol
    1e-5), gradients and updates by relative norm; K5 six times a step."""
    from mxnet_tpu_torch import compiled
    from mxnet_tpu_torch.ops.conv_kernel import conv1x1_s2_dgrad
    monkeypatch.setenv("MXNET_CONV1X1_PALLAS", "1")
    card, host = _small_gluon_net(mxt.gpu(0)), _small_gluon_net(mxt.cpu())
    opt = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
    trainers = [mxt.gluon.Trainer(n.collect_params(), "sgd", dict(opt))
                for n in (card, host)]
    rng = np.random.RandomState(5)
    before = conv1x1_s2_dgrad.launches
    readings = []
    for _ in range(2):
        x = rng.rand(4, 32, 32, 3).astype(np.float32)
        y = rng.randint(0, 10, 4).astype(np.float32)
        mxt.set_block_params(host, _gluon_values(card))
        start = _gluon_values(host)
        losses = [_gluon_record(n, mxt.nd.array(x, ctx=c),
                                mxt.nd.array(y, ctx=c)).asnumpy()
                  for n, c in ((card, mxt.gpu(0)), (host, mxt.cpu()))]
        np.testing.assert_allclose(*losses, rtol=TOL, atol=1e-5)
        grads = [{n: p.grad().asnumpy()
                  for n, p in m.collect_params().items()
                  if p.grad_req != "null"} for m in (card, host)]
        # a conv bias feeds a BatchNorm: its exact gradient is 0, and the
        # computed one is rounding noise, held below 1e-3 of its weight's
        for g in grads:
            for n in [n for n in g if "_conv" in n and n.endswith("_bias")]:
                weight = g[n[:-len("bias")] + "weight"]
                assert np.linalg.norm(g.pop(n)) <= \
                    1e-3 * np.linalg.norm(weight), n
        for t in trainers:
            t.step(4)
        values = [_gluon_values(m) for m in (card, host)]
        for n, v in values[1].items():
            if "running" in n:
                np.testing.assert_allclose(values[0][n], v, rtol=TOL,
                                           atol=1e-5, err_msg=n)
        moved = [{n: v[n] - start[n] for n in grads[1]} for v in values]
        readings.append((_worst_rel(*grads), _worst_rel(*moved)))
    torch.cuda.synchronize()
    print("small Gluon ResNet gradient and update relative errors", readings)
    assert conv1x1_s2_dgrad.launches == before + 12
    assert max(max(r) for r in readings) <= SMALL_RESNET_REL, readings
    (entry,) = card._cached_jit._cache.values()
    assert isinstance(entry, compiled._Eager)     # recorded: no graph


@pytest.mark.parametrize("gate", ["1", "0"])
def test_k5_launched_under_the_tape(cuda, monkeypatch, gate):
    """With the gate on, each backward through the hybridized NHWC net
    launches K5 once at each of its six stride-2 1x1 sites, by the wgmma
    route in bf16; with it off, and in NCHW, never."""
    from mxnet_tpu_torch.ops.conv_kernel import conv1x1_s2_dgrad
    monkeypatch.setenv("MXNET_CONV1X1_PALLAS", gate)
    for layout in ("NHWC", "NCHW"):
        net = _small_gluon_net(mxt.gpu(0), layout)
        net.cast("bfloat16")
        shape = (4, 32, 32, 3) if layout == "NHWC" else (4, 3, 32, 32)
        x = mxt.nd.array(np.random.RandomState(6).rand(*shape),
                         ctx=mxt.gpu(0), dtype="bfloat16")
        y = mxt.nd.array(np.arange(4) % 10, ctx=mxt.gpu(0))
        before = conv1x1_s2_dgrad.launches
        routes = dict(conv1x1_s2_dgrad.launches_by_route)
        loss = _gluon_record(net, x, y)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(loss.data.float()).all())
        want = 6 if gate == "1" and layout == "NHWC" else 0
        assert conv1x1_s2_dgrad.launches == before + want
        assert conv1x1_s2_dgrad.launches_by_route["wgmma"] == \
            routes["wgmma"] + want


def test_inference_graph_after_a_training_step(f32):
    """A recorded call runs eagerly; the inference call stays one graph,
    and the optimizer's in-place update reaches its next replay without a
    recapture."""
    from mxnet_tpu_torch import compiled
    net = _small_gluon_net(mxt.gpu(0), "NCHW")
    x = mxt.nd.array(np.random.RandomState(7).rand(4, 3, 32, 32),
                     ctx=mxt.gpu(0))
    compiled.reset()
    first = net(x).data.clone()
    _gluon_record(net, x, mxt.nd.array(np.arange(4), ctx=mxt.gpu(0)))
    mxt.gluon.Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.1}).step(4)
    after = net(x).data
    with mxt.autograd.predict_mode():
        eager = net._forward_impl(x).data
    assert compiled.compile_counts() == {"compiles": 2, "cache_hits": 1,
                                         "retraces": 1, "uncaptured": 0}
    assert not torch.equal(after, first)
    torch.testing.assert_close(after, eager, rtol=HYB_TOL, atol=HYB_TOL)
    kinds = sorted(type(e).__name__ for e in net._cached_jit._cache.values())
    assert kinds == ["_Eager", "_Graph"]


def test_second_order_grad_on_the_card(cuda):
    rng = np.random.RandomState(8)
    values = [rng.randn(256).astype(np.float32) for _ in range(2)]
    got = []
    for ctx in (mxt.gpu(0), mxt.cpu()):
        x, w = (mxt.nd.array(v, ctx=ctx) for v in values)
        x.attach_grad()
        with mxt.autograd.record():
            y = (x * x * x * w).sum()
            g = mxt.autograd.grad(y, x, create_graph=True)
            (g * g).sum().backward()
        got.append(x.grad.asnumpy())
    np.testing.assert_allclose(got[0], got[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0], 36 * values[0] ** 3 * values[1] ** 2,
                               rtol=1e-4, atol=1e-4)


# -- the nd core: every op of `tools/op_sweep.py` on the card --------------
from mxnet_tpu_torch.tools import op_sweep  # noqa: E402

SWEEP = [(c, dt) for c in op_sweep.CASES
         for dt in (("float32", "bfloat16") if c.bf16 else ("float32",))]


@pytest.mark.parametrize("case,dtype", SWEEP,
                         ids=["%s-%d-%s" % (c.name, i, dt)
                              for i, (c, dt) in enumerate(SWEEP)])
def test_nd_core_op_on_the_card_matches_cpu(cuda, case, dtype):
    """Each op on gpu(0) against cpu() from the same inputs, held to its
    family's limit (exact ops bit for bit; bf16 to BF16_LIMIT)."""
    assert op_sweep.compare(case, mxt.gpu(0), dtype) <= \
        op_sweep.limit(case, dtype)


@pytest.mark.parametrize("family", ["arith", "transcendental", "reduction",
                                    "product"])
def test_nd_core_controls_fail_their_limits(cuda, family):
    """Inputs rounded to bf16 on the card only read above the family's
    f32 limit."""
    assert op_sweep.control(mxt.gpu(0), family) > op_sweep.LIMITS[family]


def test_dropout_on_the_card(cuda):
    """p = 0.5 over 2^20 elements: the zero share within 4 sigma of 0.5,
    survivors scaled by exactly 2, one seed the same bits, the next draw
    others."""
    n = 1 << 20
    x = mxt.nd.array(np.random.RandomState(9).rand(n).astype(np.float32)
                     + 0.5, ctx=mxt.gpu(0))

    def draw():
        return mxt.nd.Dropout(x, p=0.5, mode="always")[0].data

    mxt.random.seed(11)
    a = draw()
    mxt.random.seed(11)
    b, c = draw(), draw()
    assert a.device.type == "cuda"
    assert abs(float((a == 0).float().mean()) - 0.5) <= 4 * 0.5 / n ** 0.5
    kept = a != 0
    assert torch.equal(a[kept], x.data[kept] * 2)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_hybridized_dropout_captures_in_predict_mode(cuda):
    """Outside training Dropout draws nothing, so a hybridized net that
    holds it is one CUDA graph; under record() it runs eagerly and
    drops."""
    from mxnet_tpu_torch import compiled
    net = mxt.gluon.nn.HybridSequential()
    net.add(mxt.gluon.nn.Dense(16, activation="relu", in_units=8),
            mxt.gluon.nn.Dropout(0.5))
    net.initialize(ctx=mxt.gpu(0))
    net.hybridize()
    x = mxt.nd.array(np.random.RandomState(10).rand(4, 8), ctx=mxt.gpu(0))
    before = compiled.compile_counts()
    eager = net._forward_impl(x).data.clone()
    first, second = net(x).data.clone(), net(x).data
    after = compiled.compile_counts()
    assert after["compiles"] - before["compiles"] == 1
    assert after["cache_hits"] - before["cache_hits"] == 1
    assert torch.equal(first, eager) and torch.equal(second, eager)
    kinds = sorted(type(e).__name__ for e in net._cached_jit._cache.values())
    assert kinds == ["_Graph"]
    with mxt.autograd.record():
        dropped = net(x).data
    assert bool((dropped == 0).any()) and not torch.equal(dropped, eager)


def test_fgsm_example_runs_on_the_card(cuda, monkeypatch, capsys):
    """fgsm_mnist through run_example under gpu(0): its accuracy line,
    its parameters stepped on cuda:0."""
    import os
    from mxnet_tpu_torch.tools.run_example import run_example
    devices = set()
    step = mxt.gluon.Trainer.step

    def spy(self, *args, **kwargs):
        devices.update(str(p.data().data.device) for p in self._params)
        return step(self, *args, **kwargs)

    monkeypatch.setattr(mxt.gluon.Trainer, "step", spy)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    run_example(os.path.join(root, "examples", "adversary", "fgsm_mnist.py"),
                ["--num-examples", "600", "--num-epochs", "2"], "gpu")
    assert "adversarial accuracy" in capsys.readouterr().out
    assert devices == {"cuda:0"}


# -- U1: the multi-tensor update ----------------------------------------------
# f32: the kernel rounds where the plain version's PyTorch ops round, so the
# two agree to f32 rounding (rtol 1e-6, atol 1e-7); bf16 weights: at most
# one bf16 step apart
U1_SHAPES = [(64,), (1000, 3), (3, 3, 64, 64), (8193,), (5,)]


def _u1_lists(formula, dtype, device, seed):
    from mxnet_tpu_torch.ops.multi_tensor import FORMULAS
    rng = np.random.RandomState(seed)
    n_states = FORMULAS[formula][2]
    out = []
    for shape in U1_SHAPES:
        w = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        g = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 3)
        states = [torch.from_numpy(np.abs(rng.randn(*shape)).astype(
            np.float32)) for _ in range(n_states)]
        if formula.startswith("mp_"):
            states[-1] = w.clone()          # the master copy
        out.append((w.to(device, dtype), g.to(device, dtype),
                    tuple(s.to(device) for s in states)))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("formula", ["sgd", "sgd_mom", "mp_sgd",
                                     "mp_sgd_mom", "adam"])
@pytest.mark.parametrize("clip", [-1.0, 1.5])
def test_u1_matches_plain(cuda, formula, dtype, clip):
    from mxnet_tpu_torch.ops.multi_tensor import (
        UpdateBuffers, multi_tensor_update, multi_tensor_update_plain)
    got = _u1_lists(formula, dtype, cuda, 0)
    want = [(w.clone(), g, tuple(s.clone() for s in st))
            for w, g, st in got]
    lrs = [0.05 * (k + 1) for k in range(len(got))]
    wds = [1e-3 * k for k in range(len(got))]
    kw = dict(rescale_grad=0.25, clip_gradient=clip, momentum=0.9,
              beta1=0.8, beta2=0.99, epsilon=1e-6)
    buffers = UpdateBuffers()
    before = multi_tensor_update.launches
    for _ in range(3):
        multi_tensor_update(formula, *[list(x) for x in zip(*got)], lrs, wds,
                            buffers=buffers, **kw)
        multi_tensor_update_plain(formula, *[list(x) for x in zip(*want)],
                                  lrs, wds, **kw)
    torch.cuda.synchronize()
    assert multi_tensor_update.launches - before == 3
    for (w, _, st), (w_ref, _, st_ref) in zip(got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(w, w_ref, rtol=1e-6, atol=1e-7)
        else:
            torch.testing.assert_close(w.float(), w_ref.float(),
                                       rtol=2 ** -7, atol=1e-7)
        for s, s_ref in zip(st, st_ref):
            torch.testing.assert_close(s, s_ref, rtol=1e-6, atol=1e-7)


def test_u1_is_bitwise_deterministic_and_tracks_addresses(cuda):
    from mxnet_tpu_torch.ops.multi_tensor import (UpdateBuffers,
                                                  multi_tensor_update)
    runs = []
    for _ in range(2):
        lists = _u1_lists("adam", torch.float32, cuda, 1)
        buffers = UpdateBuffers()
        for _ in range(5):
            multi_tensor_update("adam", *[list(x) for x in zip(*lists)],
                                [0.01] * 5, [1e-4] * 5, buffers=buffers)
        runs.append([w.clone() for w, _, _ in lists])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    key = buffers.key
    lists[0] = (lists[0][0], lists[0][1],
                tuple(s.clone() for s in lists[0][2]))   # new addresses
    multi_tensor_update("adam", *[list(x) for x in zip(*lists)],
                        [0.01] * 5, [1e-4] * 5, buffers=buffers)
    assert buffers.key != key


def test_u1_bumps_the_versions_it_writes(cuda):
    """A graph that saved the weight raises on backward after the kernel
    wrote it, as after an in-place op."""
    from mxnet_tpu_torch.ops.multi_tensor import multi_tensor_update
    w = torch.randn(16, device=cuda, requires_grad=True)
    y = (w * w).sum()
    with torch.no_grad():
        multi_tensor_update("sgd", [w], [torch.ones_like(w)], [()], [0.1],
                            [0.0])
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        y.backward()


def test_u1_refuses_what_it_cannot_take(cuda):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops.multi_tensor import multi_tensor_update
    w = torch.zeros(8, device=cuda, dtype=torch.float16)
    with pytest.raises(MXNetError, match="f32 or bf16"):
        multi_tensor_update("sgd", [w], [w.clone()], [()], [0.1], [0.0])
    w = torch.zeros(8, device=cuda)
    with pytest.raises(MXNetError, match="gradient"):
        multi_tensor_update("sgd", [w], [w.double()], [()], [0.1], [0.0])
    with pytest.raises(MXNetError, match="contiguous"):
        multi_tensor_update("sgd", [w[::2]], [w[::2]], [()], [0.1], [0.0])
    with pytest.raises(MXNetError, match="states"):
        multi_tensor_update("sgd_mom", [w], [w.clone()], [()], [0.1], [0.0])


def test_trainer_on_the_card_launches_u1_once_a_group(cuda):
    """SGD with multi_precision over f32 and bf16 parameters on the card:
    one launch for each (formula, dtype) group a step, and the weights of
    the same net updated index by index with the plain update ops (f32 to
    rounding, bf16 one step)."""
    from mxnet_tpu_torch.ops.multi_tensor import multi_tensor_update
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
           "multi_precision": True}
    nets = []
    for _ in range(2):
        mxt.random.seed(0)
        net = mxt.gluon.nn.HybridSequential(prefix="n_")
        with net.name_scope():
            net.add(mxt.gluon.nn.Dense(16, in_units=8),
                    mxt.gluon.nn.Dense(4, in_units=16))
        net.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0))
        net[1].cast("bfloat16")
        nets.append(net)
    params = [list(n.collect_params().values()) for n in nets]
    trainer = mxt.gluon.Trainer(params[0], "sgd", dict(opt))
    updater = mxt.optimizer.get_updater(mxt.optimizer.create(
        "sgd", rescale_grad=1 / 5, **opt))
    x = mxt.nd.array(np.random.RandomState(0).randn(5, 8), ctx=mxt.gpu(0))
    before = multi_tensor_update.launches
    for _ in range(2):
        for net in nets:
            with mxt.autograd.record():
                out = net[1](net[0](x).astype("bfloat16"))
                loss = (out.astype("float32") ** 2).sum()
            loss.backward()
        trainer.step(5)
        for i, p in enumerate(params[1]):
            updater(i, p.grad(), p.data())
    assert multi_tensor_update.launches - before == 4
    for a, b in zip(*params):
        if a.data().data.dtype == torch.float32:
            torch.testing.assert_close(a.data().data, b.data().data,
                                       rtol=1e-6, atol=1e-7)
        else:
            torch.testing.assert_close(a.data().data.float(),
                                       b.data().data.float(),
                                       rtol=2 ** -7, atol=1e-7)


# ---------------------------------------------------------------------------
# The detection slice: N1 (greedy NMS) and the ops on the card
# ---------------------------------------------------------------------------
def _nms_tensors(batch, n, seed, device, **kw):
    from mxnet_tpu_torch.tools.detection_sweep import nms_inputs
    return [torch.from_numpy(a).to(device)
            for a in nms_inputs(batch, n, seed, **kw)]


@pytest.mark.parametrize("n", [1, 63, 64, 65, 6000, 8732])
@pytest.mark.parametrize("force", [False, True])
def test_n1_matches_plain(cuda, n, force):
    """N1's keep mask equals the plain version's bit for bit, for every
    topk (applied before the sweep), with and without classes."""
    from mxnet_tpu_torch.ops.contrib_ops import greedy_nms_keep
    from mxnet_tpu_torch.ops.nms_kernel import greedy_nms
    batch = 2 if n < 6000 else 1
    cpu_in = _nms_tensors(batch, n, n, "cpu")
    gpu_in = [t.to(cuda) for t in cpu_in]
    topks = (-1, 1, max(1, n // 3), n, n + 5) if n < 6000 else (-1, 300)
    for topk in topks:
        for thresh in (0.45, 0.7):
            before = greedy_nms.launches
            got = greedy_nms_keep(*gpu_in[:3], gpu_in[3], thresh, topk, force)
            want = greedy_nms_keep(*cpu_in[:3], cpu_in[3], thresh, topk,
                                   force)
            assert greedy_nms.launches == before + 1
            assert torch.equal(got.cpu(), want), (topk, thresh)


def test_n1_identical_boxes_and_determinism(cuda):
    from mxnet_tpu_torch.ops.contrib_ops import greedy_nms_keep
    boxes, scores, valid, _ = _nms_tensors(3, 100, 0, cuda, identical=True)
    keep = greedy_nms_keep(boxes, scores, valid, None, 0.5, -1, True)
    assert keep.sum(dim=1).tolist() == [1, 1, 1] and bool(keep[:, 0].all())
    boxes, scores, valid, cls = _nms_tensors(4, 3000, 1, cuda)
    first = greedy_nms_keep(boxes, scores, valid, cls, 0.5, -1, False)
    for _ in range(20):
        assert torch.equal(
            greedy_nms_keep(boxes, scores, valid, cls, 0.5, -1, False), first)


def test_n1_raises_when_its_library_fails_to_build(cuda, monkeypatch):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import nms_kernel

    def broken(name):
        raise MXNetError("nvcc failed for csrc/%s.cu" % name)

    monkeypatch.setattr(nms_kernel._build, "library", broken)
    boxes, scores, valid, _ = _nms_tensors(1, 10, 0, cuda)
    with pytest.raises(MXNetError, match="nvcc failed"):
        nms_kernel.greedy_nms(boxes, valid, None, 0.5)


def _detection_cases():
    from mxnet_tpu_torch.tools import detection_sweep
    return [pytest.param(c, id="%s-%d" % (c.name, i))
            for i, c in enumerate(detection_sweep.CASES)]


@pytest.mark.parametrize("case", _detection_cases())
def test_detection_op_on_the_card_matches_cpu(cuda, case):
    """Forward and gradients against the CPU, within the family's limit,
    with no host synchronisation on the card."""
    from mxnet_tpu_torch.tools import detection_sweep
    want = detection_sweep.run_case(case, mxt.cpu())
    got = detection_sweep.run_case(case, mxt.gpu(0), no_sync=True)
    limit = detection_sweep.LIMITS[case.family]
    assert detection_sweep.reading(got[0], want[0], case.family) <= limit
    assert detection_sweep.reading(got[1], want[1], case.family,
                                   norm=True) <= limit


@pytest.mark.parametrize("family", ["box", "pool", "sample"])
def test_detection_controls_fail_their_limits(cuda, family):
    from mxnet_tpu_torch.tools import detection_sweep
    assert detection_sweep.control(mxt.gpu(0), family) > \
        detection_sweep.LIMITS[family]


def test_box_ops_launch_n1_on_the_card(cuda):
    """box_nms, MultiBoxDetection and Proposal each launch N1 once a call
    on the card."""
    from mxnet_tpu_torch.ops.nms_kernel import greedy_nms
    from mxnet_tpu_torch.tools import detection_sweep
    for name in ("_contrib_box_nms", "_contrib_MultiBoxDetection",
                 "_contrib_Proposal"):
        case = next(c for c in detection_sweep.CASES if c.name == name)
        before = greedy_nms.launches
        detection_sweep.run_case(case, mxt.gpu(0))
        assert greedy_nms.launches == before + 1, name


# -- S1, the lazy row-sparse update -------------------------------------------
#: (rows, columns, stored rows): the example's push, ragged widths, one column
S1_SHAPES = [(20000, 32, 192), (5000, 300, 77), (3000, 1, 500),
             (4096, 128, 4096)]
S1_CASES = [(f, torch.float32) for f in ("sgd", "sgd_mom", "adam",
                                         "adagrad")] + \
    [(f, torch.bfloat16) for f in ("sgd", "sgd_mom")]
S1_KW = dict(lr=0.05, rescale_grad=0.5, momentum=0.9, beta1=0.8, beta2=0.99,
             epsilon=1e-6)


def _s1_inputs(formula, dtype, shape, device, seed, vdtype=torch.float32,
               idtype=torch.int64):
    from mxnet_tpu_torch.ops.sparse_update import FORMULAS
    rows, d, nnz = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((rows, d), generator=gen, device=device).to(dtype)
    states = tuple(torch.rand((rows, d), generator=gen, device=device) + 0.1
                   for _ in range(FORMULAS[formula][1]))
    idx = torch.randperm(rows, generator=gen, device=device)[:nnz]
    vals = (torch.randn((nnz, d), generator=gen, device=device) * 3)
    return w, states, vals.to(vdtype), idx.to(idtype)


@pytest.mark.parametrize("shape", S1_SHAPES, ids=str)
@pytest.mark.parametrize("formula,dtype", S1_CASES,
                         ids=["%s-%s" % (f, str(d)[6:]) for f, d in S1_CASES])
@pytest.mark.parametrize("clip,wd", [(None, 0.0), (0.75, 1e-4)])
def test_s1_matches_plain_bit_for_bit(cuda, formula, dtype, shape, clip, wd):
    """3 pushes: S1 and its plain version on the same card inputs agree
    bit for bit, and every row no push names keeps its bits."""
    from mxnet_tpu_torch.ops.sparse_update import (sparse_row_update,
                                                   sparse_row_update_plain)
    w, states, _, _ = _s1_inputs(formula, dtype, shape, cuda, 0)
    w0, s0 = w.clone(), tuple(s.clone() for s in states)
    ref_w, ref_s = w.clone(), tuple(s.clone() for s in states)
    touched = torch.zeros(shape[0], dtype=torch.bool, device=cuda)
    before = sparse_row_update.launches
    for push in range(3):
        _, _, vals, idx = _s1_inputs(formula, dtype, shape, cuda, 1 + push)
        sparse_row_update(formula, w, vals, idx, states, wd=wd,
                          clip_gradient=clip, **S1_KW)
        sparse_row_update_plain(formula, ref_w, vals, idx, ref_s, wd=wd,
                                clip_gradient=clip, **S1_KW)
        touched[idx] = True
    torch.cuda.synchronize()
    assert sparse_row_update.launches - before == 3
    assert torch.equal(w, ref_w)
    for s, r in zip(states, ref_s):
        assert torch.equal(s, r)
    rest = ~touched
    assert torch.equal(w[rest], w0[rest])
    for s, r in zip(states, s0):
        assert torch.equal(s[rest], r[rest])


@pytest.mark.parametrize("vdtype,idtype", [(torch.bfloat16, torch.int64),
                                           (torch.float32, torch.int32)])
def test_s1_takes_the_payloads_dtypes(cuda, vdtype, idtype):
    from mxnet_tpu_torch.ops.sparse_update import (sparse_row_update,
                                                   sparse_row_update_plain)
    w, states, vals, idx = _s1_inputs("adam", torch.float32, (1000, 40, 64),
                                      cuda, 3, vdtype, idtype)
    ref_w, ref_s = w.clone(), tuple(s.clone() for s in states)
    sparse_row_update("adam", w, vals, idx, states, **S1_KW)
    sparse_row_update_plain("adam", ref_w, vals, idx, ref_s, **S1_KW)
    assert torch.equal(w, ref_w)
    assert all(torch.equal(a, b) for a, b in zip(states, ref_s))


def test_s1_is_deterministic_without_host_reads(cuda):
    """20 calls from the same inputs give the same bits; the launch reads
    nothing back from the card; nnz 0 launches nothing."""
    from mxnet_tpu_torch.ops.sparse_update import sparse_row_update
    w0, s0, vals, idx = _s1_inputs("adam", torch.float32, (20000, 32, 192),
                                   cuda, 4)
    outs = []
    for _ in range(20):
        w, states = w0.clone(), tuple(s.clone() for s in s0)
        torch.cuda.set_sync_debug_mode("error")
        try:
            sparse_row_update("adam", w, vals, idx, states, **S1_KW)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outs.append((w, states))
    for w, states in outs[1:]:
        assert torch.equal(w, outs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(states, outs[0][1]))
    before = sparse_row_update.launches
    sparse_row_update("adam", w, vals[:0], idx[:0], states, **S1_KW)
    assert sparse_row_update.launches == before


def test_s1_bumps_versions_and_refuses_what_it_cannot_take(cuda):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops.sparse_update import sparse_row_update
    w = torch.randn(16, 4, device=cuda, requires_grad=True)
    y = (w * w).sum()
    ones, idx = torch.ones(2, 4, device=cuda), torch.tensor([3, 9],
                                                              device=cuda)
    with torch.no_grad():
        sparse_row_update("sgd", w, ones, idx, (), lr=0.1)
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        y.backward()
    w = torch.zeros(16, 4, device=cuda)
    with pytest.raises(MXNetError, match="f32 or bf16"):
        sparse_row_update("sgd", w.half(), ones, idx, (), lr=0.1)
    with pytest.raises(MXNetError, match="do not match"):
        sparse_row_update("sgd", w, torch.ones(3, 4, device=cuda), idx, (),
                          lr=0.1)
    with pytest.raises(MXNetError, match="states"):
        sparse_row_update("adam", w, ones, idx, (torch.zeros_like(w),),
                          lr=0.1)
    with pytest.raises(MXNetError, match="must be on"):
        sparse_row_update("sgd", w, ones, idx.cpu(), (), lr=0.1)


def test_lazy_pushes_on_the_card_match_the_cpu(cuda):
    """5 row-sparse pushes through a local kvstore with lazy Adam and with
    SGD momentum, on gpu(0) and on cpu(): weights and states to rtol 1e-6,
    atol 1e-7; one S1 launch a push on the card."""
    from mxnet_tpu_torch.ndarray import sparse
    from mxnet_tpu_torch.ops.sparse_update import sparse_row_update
    rng = np.random.RandomState(9)
    w0 = rng.randn(5000, 16).astype("f")
    pushes = [(np.unique(rng.randint(0, 5000, 300)),) for _ in range(5)]
    pushes = [(r, (rng.randn(len(r), 16) * 2).astype("f"))
              for (r,) in pushes]
    for opt_name, kw in (("adam", {"learning_rate": 0.05}),
                         ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                  "wd": 1e-4})):
        out = {}
        for ctx in (mxt.cpu(), mxt.gpu(0)):
            kv = mxt.kv.create("local")
            kv.init("emb", mxt.nd.array(w0, ctx=ctx))
            kv.set_optimizer(mxt.optimizer.create(opt_name, **kw))
            before = sparse_row_update.launches
            for rows, vals in pushes:
                kv.push("emb", sparse.row_sparse_array(
                    (vals, rows), shape=w0.shape, ctx=ctx))
            launched = sparse_row_update.launches - before
            assert launched == (5 if ctx == mxt.gpu(0) else 0)
            st = kv._updater.states["emb"]
            st = st if isinstance(st, tuple) else (st,)
            out[ctx.device_type] = [kv._store["emb"].asnumpy()] + \
                [s.asnumpy() for s in st]
        for a, b in zip(out["cpu"], out["gpu"]):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


def test_csr_dot_and_its_backward_on_the_card(cuda):
    """CSR x dense and its taped backward at wide-deep's shapes (batch 64
    x 2000 features, 10 stored a row, x 2000 x 8) against the CPU, rtol
    1e-5 (index_add_'s atomics sum in another order)."""
    from mxnet_tpu_torch.ndarray import sparse
    rng = np.random.RandomState(2)
    cols = np.stack([rng.choice(2000, 10, replace=False) for _ in range(64)])
    dense = np.zeros((64, 2000), "f")
    dense[np.arange(64)[:, None], cols] = rng.rand(64, 10)
    rhs0 = rng.randn(2000, 8).astype("f")
    out = {}
    for ctx in (mxt.cpu(), mxt.gpu(0)):
        csr = sparse.csr_matrix(dense, ctx=ctx)
        rhs = mxt.nd.array(rhs0, ctx=ctx)
        rhs.attach_grad()
        with mxt.autograd.record():
            y = sparse.dot(csr, rhs)
            loss = (y * y).sum()
        loss.backward()
        out[ctx.device_type] = (y.asnumpy(), rhs.grad.asnumpy())
        assert csr.has_compact() and csr._dense is None
    for a, b in zip(out["cpu"], out["gpu"]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
