"""The port's runprof, memprof and xla_stats against the JAX package's.

Parity on the same inputs, drawn from a numpy seed:

- runprof: a private ``RunLedger`` of each package takes the same notes
  (explicit states, steps with their phases, metric values, anomalies);
  the explicit states' seconds agree to 1e-12, the anomaly counts and
  kinds exactly, and ``classify`` gives the same verdict label for the
  same states (the hints are the port's own text);
- memprof: ``classify``, ``aggregate`` and ``parse_requested_bytes`` give
  equal results on the same attributions, snapshot documents and
  allocator messages (the port's CUDA message included);
- xla_stats: ``mfu_of`` and ``goodput`` after ``note_train_step`` agree
  to 1e-12 with ``MXNET_PEAK_FLOPS`` set in both (the JAX package
  multiplies the peak by its device count, 8 virtual CPU devices here,
  the port by its one card: the JAX side is held to one device).

On the port alone: the model FLOPs of a small NHWC ResNet v1's Module
step (gate on, so K5's plain version runs) equal exactly an analytic
count from the traced symbol's convolution and dense shapes (2 x MACs
forward, the weight gradient of every layer, the input gradient of
every layer but the first convolution); a hand kernel's analytic term
reaches an open count; the ledger books the bound bytes exactly; the
leak sentinel trips on monotonic growth and not on a flat timeline; an
armed ``memory.oom`` chaos site at a program's dispatch raises
``DeviceOOMError`` with the requested bytes and a postmortem file; and
the non-finite gradient norm of ``clip_global_norm`` books its anomaly.
"""
import io
import json

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

PKGS = (mx, mxt)
EXPLICIT = ("compile", "train_productive", "checkpoint_save",
            "checkpoint_restore", "recovery", "input_stall")


def _ledger(pkg, seed):
    rng = np.random.RandomState(seed)
    led = pkg.runprof.RunLedger(window=32)
    for i in range(30):
        if i % 7 == 0:
            led.note_state("compile", float(rng.exponential(0.5)),
                           span=False)
        phases = {"data_wait": float(rng.exponential(0.01)),
                  "dispatch": float(rng.exponential(0.05))}
        led.note_step(phases, sum(phases.values()) +
                      float(rng.exponential(0.01)), batches=1)
        led.observe_metrics([("cross-entropy",
                              float(rng.rand()) if i != 20
                              else float("nan"))])
    led.note_anomaly("memory_leak", detail="x", value=1.0, dump=False)
    return led


@pytest.mark.parametrize("seed", [0, 1])
def test_run_ledger_states_match(seed):
    lj, lt = _ledger(mx, seed), _ledger(mxt, seed)
    sj, st = lj.state_seconds(), lt.state_seconds()
    for state in EXPLICIT:
        assert st[state] == pytest.approx(sj[state], rel=1e-12, abs=1e-15)
    dj, dt = lj.snapshot(), lt.snapshot()
    assert dj.keys() == dt.keys()
    assert dj["anomaly_counts"] == dt["anomaly_counts"]
    assert [a["kind"] for a in dj["anomalies"]] == \
        [a["kind"] for a in dt["anomalies"]]
    assert mx.runprof.classify(sj)[0] == mxt.runprof.classify(st)[0]


@pytest.mark.parametrize("states", [
    {"train_productive": 9.0, "compile": 0.5},
    {"train_productive": 2.0, "compile": 5.0},
    {"train_productive": 2.0, "input_stall": 4.0, "init": 0.5},
    {"train_productive": 1.0, "idle": 6.0},
    {},
])
def test_runprof_classify_matches(states):
    full = {s: 0.0 for s in mxt.runprof.RUN_STATES}
    full.update(states)
    assert mx.runprof.classify(full)[0] == mxt.runprof.classify(full)[0]


ATTS = [
    {"params": 100, "grads": 100, "aux": 10, "optimizer": 50,
     "residual": 900},
    {"params": 100, "grads": 100, "aux": 10, "optimizer": 800,
     "residual": 50},
    {"params": 500, "grads": 500, "aux": 10, "optimizer": 100,
     "residual": 100},
    {},
]


@pytest.mark.parametrize("att", ATTS)
def test_memprof_classify_matches(att):
    for kw in ({}, {"leak_trips": 1}, {"live_bytes": 1000,
                                       "in_use": 10 ** 7}):
        assert mx.memprof.classify(att, **kw)[0] == \
            mxt.memprof.classify(att, **kw)[0]


def test_memprof_aggregate_matches():
    rng = np.random.RandomState(3)
    docs = []
    for h in range(3):
        docs.append({"host": h, "samples": int(rng.randint(1, 9)),
                     "peak_hbm_bytes": int(rng.randint(1, 10 ** 9)),
                     "live_bytes": int(rng.randint(1, 10 ** 8)),
                     "leak_trips": int(rng.randint(2)),
                     "oom_dumps": int(rng.randint(2)),
                     "admission_rejections": 0,
                     "attribution": {"params": int(rng.randint(10 ** 6)),
                                     "residual": int(rng.randint(10 ** 6))},
                     "timeline": [{"devices": [
                         {"device": "d0", "in_use": int(rng.randint(99))}]}]})
    assert mx.memprof.aggregate(docs) == mxt.memprof.aggregate(docs)


MESSAGES = [
    "RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
    "40000000000 bytes.",
    "Attempting to allocate 37.25G. That was not possible.",
    "CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 has a total "
    "capacity of 79.11 GiB of which 3.12 GiB is free.",
    "CUDA out of memory. Tried to allocate 1073741824 bytes. (chaos)",
    "allocation of 1,024 KiB failed",
    "no size here",
]


@pytest.mark.parametrize("msg", MESSAGES)
def test_parse_requested_bytes_matches(msg):
    assert mx.memprof.parse_requested_bytes(msg) == \
        mxt.memprof.parse_requested_bytes(msg)


def test_cuda_message_parses_to_the_request():
    assert mxt.memprof.parse_requested_bytes(MESSAGES[2]) == 20 << 30
    assert mxt.memprof.looks_like_oom(RuntimeError(MESSAGES[2]))
    wrapped = ValueError("capture failed")
    wrapped.__cause__ = RuntimeError(MESSAGES[2])
    assert mxt.memprof.looks_like_oom(wrapped)


def test_goodput_and_mfu_match(monkeypatch):
    monkeypatch.setenv("MXNET_PEAK_FLOPS", "1.5e14")
    monkeypatch.setattr(mx.xla_stats, "peak_flops_total",
                        mx.xla_stats.peak_flops_per_device)
    rng = np.random.RandomState(4)
    flops = float(rng.randint(10 ** 9, 10 ** 11))
    outs = []
    for pkg in PKGS:
        pkg.xla_stats.reset()
        pkg.xla_stats.note_train_step(flops, batches=2)
        outs.append((pkg.xla_stats.flops_per_batch(),
                     pkg.xla_stats.mfu_of(3.0e13),
                     pkg.xla_stats.goodput(7, 0.25)))
        pkg.xla_stats.reset()
    (fj, mj, gj), (ft, mt, gt) = outs
    assert ft == fj and mt == pytest.approx(mj, rel=1e-12)
    assert gt.keys() == gj.keys()
    for k in gj:
        assert gt[k] == pytest.approx(gj[k], rel=1e-12)
    assert mxt.xla_stats.goodput(0, 1.0) is None


def test_peak_table_and_cpu_peak(monkeypatch):
    monkeypatch.delenv("MXNET_PEAK_FLOPS", raising=False)
    table = mxt.xla_stats.PEAK_FLOPS_BY_KIND
    assert table["h100"]["bfloat16"] == 989e12
    assert table["h100"]["tf32"] == 495e12
    assert table["h100"]["float32"] == 67e12
    assert mxt.xla_stats.peak_flops_per_device() == 0.0   # the CPU
    assert mxt.xla_stats.mfu_of(1e12) == 0.0


def test_kernel_term_reaches_an_open_count(monkeypatch):
    import torch
    from mxnet_tpu_torch.ops import launch_count
    # a launch happens on a CUDA stream: stand in for one that is not
    # capturing (this torch may be built without CUDA)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)

    def fake():
        pass
    fake.launches = 0
    with mxt.xla_stats.count_flops() as outer:
        with mxt.xla_stats.count_flops() as inner:
            launch_count.count(fake, flops=123)
        launch_count.count(fake, flops=7)
    assert (inner.total, inner.kernel_flops) == (123, 123)
    assert outer.kernel_flops == 130 and fake.launches == 2


SPEC = ([1, 1, 1, 1], [16, 128, 256, 384, 512])
SHAPE = (2, 32, 32, 3)


def _analytic_flops(sym, data_shape):
    """2 x MACs of every Convolution and FullyConnected forward, plus its
    weight gradient, plus its input gradient unless it reads the data."""
    internals = sym.get_internals()
    arg_shapes, out_shapes, _ = internals.infer_shape(data=data_shape)
    shape_of = dict(zip(internals.list_outputs(), out_shapes))
    shape_of.update(zip(internals.list_arguments(), arg_shapes))
    total = 0
    for node in sym._topo_nodes():
        if node.is_var() or node.op not in ("Convolution",
                                            "FullyConnected"):
            continue
        out = shape_of[node.name + "_output"]
        w = shape_of[node.inputs[1][0].name]
        macs = int(np.prod(out)) * int(np.prod(w[1:]))
        src = node.inputs[0][0]
        total += 2 * macs * (2 if src.is_var() else 3)
    return total


def test_module_flops_match_the_symbol(monkeypatch):
    from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
    monkeypatch.setenv("MXNET_CONV1X1_PALLAS", "1")
    net = tvision.ResNetV1(tvision.BottleneckV1, *SPEC, classes=10,
                           layout="NHWC", prefix="net_")
    net.initialize(mxt.init.Xavier(), ctx=mxt.cpu())
    net(mxt.nd.zeros(SHAPE, ctx=mxt.cpu()))
    sym = mxt.sym.SoftmaxOutput(net._trace_symbol(), name="softmax")
    mxt.xla_stats.reset()
    mod = mxt.mod.Module(sym, context=mxt.cpu())
    mod.bind(data_shapes=[("data", SHAPE)],
             label_shapes=[("softmax_label", (SHAPE[0],))])
    params = {p.name: p.data() for p in net.collect_params().values()}
    mod.init_params(
        arg_params={n: params[n] for n in sym.list_arguments()
                    if n in params},
        aux_params={n: params[n] for n in sym.list_auxiliary_states()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.01,
                                         "momentum": 0.9})
    batch = mxt.io.DataBatch(
        data=[mxt.nd.ones(SHAPE, ctx=mxt.cpu())],
        label=[mxt.nd.zeros((SHAPE[0],), ctx=mxt.cpu())])
    mod._step(batch)
    want = _analytic_flops(sym, SHAPE)
    assert mxt.xla_stats.flops_per_batch() == want
    # the ledger: params, grads, aux and (after the update) the optimizer
    led = {sec: b for (scope, sec), b in mxt.xla_stats.ledger().items()
           if scope == "softmax"}
    ex = mod._exec
    assert led["params"] == sum(ex.arg_dict[n].data.nbytes
                                for n in mod._param_names)
    assert led["grads"] == sum(g.data.nbytes for g in ex.grad_dict.values())
    assert led["aux"] == sum(a.data.nbytes for a in ex.aux_dict.values())
    assert led["optimizer"] == led["params"]      # one momentum a weight
    mxt.xla_stats.reset()


def _stats_feed(values):
    it = iter(values)

    def stats(limit=64):
        return [{"device": "cuda:0", "kind": "test",
                 "bytes_in_use": next(it), "peak_bytes_in_use": 0,
                 "bytes_limit": 1 << 34}]
    return stats


@pytest.mark.parametrize("growing", [True, False])
def test_leak_sentinel(monkeypatch, growing):
    step = 1 << 20
    values = [(i * step if growing else 5 * step) for i in range(64)]
    monkeypatch.setattr(mxt.memprof, "_raw_device_stats", _stats_feed(values))
    monkeypatch.setenv("MXNET_MEMPROF_WINDOW", "8")
    monkeypatch.setenv("MXNET_MEMPROF_SAMPLE_EVERY", "1")
    tracker = mxt.memprof.MemTracker()
    for _ in range(10):
        tracker.sample("test")
    snap = tracker.snapshot()
    assert snap["leak_trips"] == (1 if growing else 0)
    if growing:
        assert "grew %d B over 8 samples" % (7 * step) in \
            snap["last_leak"]["detail"]


def test_chaos_oom_at_dispatch(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_TELEMETRY_DIR", str(tmp_path))
    net = mxt.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mxt.cpu())
    net.hybridize()
    x = mxt.nd.ones((1, 3), ctx=mxt.cpu())
    net(x)
    before = mxt.telemetry.counter("oom_events_total").value
    with mxt.chaos.armed("memory.oom", value=str(3 << 30)):
        with pytest.raises(mxt.memprof.DeviceOOMError) as info:
            net(x)
    err = info.value
    assert err.requested_bytes == 3 << 30
    assert err.verdict.startswith("oom-") and err.dump_path
    doc = json.loads(open(err.dump_path).read())
    assert doc["requested_bytes"] == 3 << 30 and "top_buffers" in doc
    assert mxt.telemetry.counter("oom_events_total").value == before + 1
    net(x)      # the next call runs


def test_nonfinite_grad_norm_books_an_anomaly():
    before = mxt.runprof.snapshot()["anomaly_counts"].get(
        "nonfinite_grad_norm", 0)
    arr = mxt.nd.array(np.array([1.0, np.nan], np.float32), ctx=mxt.cpu())
    with pytest.warns(UserWarning):
        mxt.gluon.utils.clip_global_norm([arr], 1.0)
    assert mxt.runprof.snapshot()["anomaly_counts"][
        "nonfinite_grad_norm"] == before + 1


def test_memprof_report_of_a_snapshot(tmp_path):
    out = io.StringIO()
    path = tmp_path / "m.json"
    path.write_text(json.dumps(mxt.memprof.MemTracker().snapshot()))
    mxt.memprof.report(str(path), out=out, json_only=True)
    rec = json.loads(out.getvalue().splitlines()[-1])
    assert rec["metric"] == "memprof_report" and "scopes" in rec
