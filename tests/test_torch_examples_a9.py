"""The examples that the observability stack unblocked, written for the
JAX package, run on the port with one import changed
(`mxnet_tpu_torch/tools/run_example.py`), on the CPU.

Each runs in a subprocess (``python -m mxnet_tpu_torch.tools.run_example
EXAMPLE --device cpu ARGS``), so that the check that neither ``jax`` nor
``mxnet_tpu`` was imported sees a process of its own, at the arguments
of its JAX test in `tests/test_examples.py`, and must print the line
that test asserts: ``profiler`` (the aggregate table with its memory
section and the executor's entry, with and without a trace) and
``monitor.Monitor`` through ``Module.install_monitor``
(python-howto).
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXAMPLES = os.path.join(ROOT, "examples")


def _run(rel, *args, timeout=600, cwd=ROOT):
    # one intra-op thread: small ops beside the other test workers
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.run_example",
         os.path.join(EXAMPLES, rel), "--device", "cpu"] + list(args),
        capture_output=True, text=True, env=env, timeout=timeout, cwd=cwd)


A9_EXAMPLES = [
    ("profiler/profiler_example.py", [], "PROFILER EXAMPLE OK"),
    ("profiler/profiler_example.py", ["--trace"], "PROFILER EXAMPLE OK"),
    ("python-howto/data_and_ops.py", [], "PYTHON HOWTO OK"),
]


@pytest.mark.parametrize("rel,args,line", A9_EXAMPLES,
                         ids=["profiler", "profiler-trace", "python-howto"])
def test_a9_example_on_the_port(rel, args, line, tmp_path):
    r = _run(rel, *args, cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-2000:]
    assert line in r.stdout
    if "--trace" in args:
        traces = os.listdir(tmp_path / "profile_example_trace")
        assert traces and traces[0].endswith(".pt.trace.json")
