"""The port's profiler and trace table against the JAX package's.

The same ``nd`` sequence and executor forwards, from a numpy seed, run
through both packages with ``set_config(aggregate_stats=True,
profile_memory=True)``: ``profiler.dumps()`` must name the same entries
with the same counts (exact; the times differ) and both carry the
"Memory allocations" section. The JAX executor runs with
``MXNET_XLA_STATS=0``. On the CPU the port's aggregate table times a
hybridized call as one entry, whatever ops run inside it.

`xplane.py` reads chrome traces: a hand-made trace with two kernels, a
memcpy and their launching ops is tabled by kernel, by launching op
(through ``External id``, and through the runtime call's ``correlation``
for a kernel without one) and by stream, exactly; a real
``torch.profiler`` trace of CPU work falls back to the CPU ops. The
trace's lifecycle (``set_state``, ``pause``/``resume``, ``Scope``)
writes trace files into the configured directory.
"""
import json
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt


@pytest.fixture
def _plain_jit(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _table(text):
    rows = {}
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 6 and parts[1].isdigit():
            rows[parts[0]] = int(parts[1])
    return rows


def _nd_sequence(pkg, seed):
    ctx = pkg.cpu()
    pkg.profiler.set_config(aggregate_stats=True, profile_memory=True)
    try:
        rng = np.random.RandomState(seed)
        a = pkg.nd.array(rng.rand(8, 8).astype(np.float32), ctx=ctx)
        b = pkg.nd.array(rng.rand(8, 8).astype(np.float32), ctx=ctx)
        for _ in range(1 + seed):
            c = pkg.nd.dot(a, b)
            d = pkg.nd.relu(c) + a
            (d * 2 - 1).sum()
            f = pkg.nd.softmax(d, axis=-1)
            pkg.nd.transpose(f).reshape((64,))
        data = pkg.sym.Variable("data")
        net = pkg.sym.FullyConnected(data, num_hidden=4, name="fc")
        exe = net.simple_bind(ctx, data=(2, 8))
        for _ in range(2 + seed):
            exe.forward(is_train=False)
        return pkg.profiler.dumps(reset=True)
    finally:
        pkg.profiler.set_config(aggregate_stats=False)


@pytest.mark.parametrize("seed", [0, 2])
def test_dumps_names_and_counts_match(seed, _plain_jit):
    jax_text, port_text = (_nd_sequence(pkg, seed) for pkg in (mx, mxt))
    assert _table(jax_text) == _table(port_text)
    assert _table(port_text)["_executor_forward"] == 2 + seed
    for text in (jax_text, port_text):
        assert "Memory allocations" in text
    assert "Device cpu: bytes_in_use=0" in port_text
    assert mxt.profiler.dumps() == ""


def test_training_executor_is_one_forward_backward_entry():
    mxt.profiler.set_config(aggregate_stats=True)
    try:
        data = mxt.sym.Variable("data")
        net = mxt.sym.FullyConnected(data, num_hidden=3, name="fc")
        exe = net.simple_bind(mxt.cpu(), data=(2, 5))
        exe.forward_backward()
        rows = _table(mxt.profiler.dumps(reset=True))
    finally:
        mxt.profiler.set_config(aggregate_stats=False)
    assert rows == {"_executor_forward_backward": 1}


def test_hybridized_call_is_one_entry():
    net = mxt.gluon.nn.HybridSequential()
    net.add(mxt.gluon.nn.Dense(4), mxt.gluon.nn.Dense(2))
    net.initialize(ctx=mxt.cpu())
    x = mxt.nd.ones((3, 5), ctx=mxt.cpu())
    net(x)
    net.hybridize()
    net(x)
    mxt.profiler.set_config(aggregate_stats=True)
    try:
        for _ in range(3):
            net(x)
        rows = _table(mxt.profiler.dumps(reset=True))
    finally:
        mxt.profiler.set_config(aggregate_stats=False)
    assert len(rows) == 1 and list(rows.values()) == [3], rows


def _trace(path):
    """Two kernels (one joined by External id, one by correlation), a
    memcpy, their ops and runtime calls."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1,
         "ts": 0, "dur": 50, "args": {"External id": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "my_backward", "pid": 1,
         "tid": 1, "ts": 60, "dur": 40, "args": {"External id": 8}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 10, "dur": 5,
         "args": {"correlation": 101, "External id": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 70, "dur": 5,
         "args": {"correlation": 102}},
        {"ph": "X", "cat": "kernel", "name": "gemm_kernel", "pid": 0,
         "tid": 7, "ts": 20, "dur": 30,
         "args": {"correlation": 101, "External id": 7}},
        {"ph": "X", "cat": "kernel", "name": "dgrad_kernel", "pid": 0,
         "tid": 7, "ts": 80, "dur": 10, "args": {"correlation": 102}},
        {"ph": "X", "cat": "kernel", "name": "dgrad_kernel", "pid": 0,
         "tid": 7, "ts": 95, "dur": 12, "args": {"correlation": 102}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0,
         "tid": 9, "ts": 45, "dur": 10, "args": {}},
    ]
    with open(path, "w") as fh:
        json.dump({"traceEvents": ev}, fh)


def test_xplane_tables_a_trace(tmp_path):
    _trace(tmp_path / "t.pt.trace.json")
    by_op = mxt.xplane.op_table(str(tmp_path))
    assert {k: (v["count"], v["total_ps"]) for k, v in by_op.items()} == {
        "gemm_kernel": (1, 30_000_000), "dgrad_kernel": (2, 22_000_000),
        "Memcpy HtoD": (1, 10_000_000)}
    by_cat = mxt.xplane.op_table(str(tmp_path), by="category",
                                 line_filter="kernel")
    assert {k: v["count"] for k, v in by_cat.items()} == {
        "aten::mm": 1, "my_backward": 2}
    by_stream = mxt.xplane.op_table(str(tmp_path), by="instance")
    assert "Memcpy HtoD [stream 9]" in by_stream
    # the busy union: [20, 55] and [80, 90] and [95, 107]
    assert mxt.xplane.busy_us(str(tmp_path)) == pytest.approx(57.0)
    text = mxt.xplane.dumps(str(tmp_path))
    assert "dgrad_kernel" in text and "TOTAL" in text


def test_profiler_trace_lifecycle_and_cpu_table(tmp_path):
    prof = mxt.profiler
    prof.set_config(filename=str(tmp_path / "run.json"))
    prof.set_state("run")
    with prof.Scope("my_scope"):
        a = mxt.nd.ones((64, 64), ctx=mxt.cpu())
        mxt.nd.dot(a, a).asnumpy()
    prof.pause()
    prof.resume()
    mxt.nd.dot(a, a).asnumpy()
    prof.set_state("stop")
    files = os.listdir(tmp_path / "run_trace")
    assert len(files) == 2
    table = mxt.xplane.op_table(str(tmp_path / "run_trace"))
    assert "my_scope" in table or any("mm" in k for k in table)
    assert "(no events)" not in prof.device_dumps()
    with pytest.raises(ValueError):
        prof.set_state("bogus")


def test_resume_without_config_warns(monkeypatch):
    monkeypatch.setitem(mxt.profiler._state, "configured", False)
    monkeypatch.setitem(mxt.profiler._state, "paused", False)
    with pytest.warns(UserWarning):
        mxt.profiler.resume()
    assert not mxt.profiler._state["running"]
