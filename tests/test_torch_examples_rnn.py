"""The RNN slice's examples, written for the JAX package, run on the
port with one import changed (`mxnet_tpu_torch/tools/run_example.py`),
on the CPU.

Each runs in a subprocess (``python -m mxnet_tpu_torch.tools.run_example
EXAMPLE --device cpu ARGS``), so that the check that neither ``jax`` nor
``mxnet_tpu`` was imported sees a process of its own, at the arguments
of its JAX test in `tests/test_examples.py`, and must print the line
that test asserts: the bucketed word LM (``BucketingModule`` over
``mx.rnn`` cells and ``BucketSentenceIter``), bi-lstm-sort (a hybridized
bidirectional ``gluon.rnn.LSTM``), LSTNet (``gluon.rnn.GRU``) and
rnn-time-major (the fused ``RNN`` op through ``Module``). With C.8
repaired, the two ``Module`` examples that build a ctx-less ``Module``
run to their last line too.
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXAMPLES = os.path.join(ROOT, "examples")


def _run(rel, *args, timeout=600):
    # one intra-op thread: these examples run thousands of small ops, whose
    # thread pool, beside the other test workers on a loaded host, spends
    # its time waiting (bi-lstm-sort: ~10 s alone, over 300 s so)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.run_example",
         os.path.join(EXAMPLES, rel), "--device", "cpu"] + list(args),
        capture_output=True, text=True, env=env, timeout=timeout, cwd=ROOT)


RNN_EXAMPLES = [
    ("rnn/word_lm/train.py",
     ["--num-epochs", "1", "--max-sentences", "300", "--batch-size", "25",
      "--num-hidden", "32", "--num-embed", "16", "--data", "/nonexistent"],
     "final train perplexity"),
    ("bi-lstm-sort/train_sort.py",
     ["--num-examples", "2000", "--num-epochs", "20"], "token accuracy"),
    ("multivariate_time_series/train_lstnet.py", [], "LSTNET FORECAST OK"),
    ("rnn-time-major/readme_bench.py", ["--steps", "10"],
     "RNN TIME-MAJOR OK"),
    ("multi-task/train_multitask.py",
     ["--num-examples", "800", "--num-epochs", "5"], "parity accuracy"),
    ("module/mod_walkthrough.py", [], "MODULE WALKTHROUGH OK"),
]


@pytest.mark.parametrize("rel,args,line", RNN_EXAMPLES,
                         ids=[r[0] for r in RNN_EXAMPLES])
def test_rnn_example_on_the_port(rel, args, line):
    r = _run(rel, *args)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-2000:]
    assert line in r.stdout
