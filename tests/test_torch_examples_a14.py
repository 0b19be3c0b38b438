"""Eleven examples written for the JAX package that ran on the port with
one import changed (`mxnet_tpu_torch/tools/run_example.py`) before any
port test held them, on the CPU.

Each runs in a subprocess (``python -m mxnet_tpu_torch.tools.run_example
EXAMPLE --device cpu ARGS``), so that the check that neither ``jax`` nor
``mxnet_tpu`` was imported sees a process of its own, at the arguments
of its JAX test in `tests/test_examples.py`, and must print the line
that test asserts (the Chinese text CNN also its accuracy above 0.8, as
its JAX test asks).
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXAMPLES = os.path.join(ROOT, "examples")


def _run(rel, *args, timeout=600):
    # one intra-op thread: small ops beside the other test workers
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.run_example",
         os.path.join(EXAMPLES, rel), "--device", "cpu"] + list(args),
        capture_output=True, text=True, env=env, timeout=timeout, cwd=ROOT)


A14_EXAMPLES = [
    ("image-classification/train_mnist.py",
     ["--num-epochs", "4", "--num-examples", "600", "--batch-size", "50"],
     "final validation"),
    ("nce-loss/train_nce.py", [], "rank-1 accuracy"),
    ("neural-style/neural_style.py", ["--size", "32", "--iters", "40"],
     "NEURAL STYLE OK"),
    ("reinforcement-learning/parallel_actor_critic.py", ["--updates", "400"],
     "PARALLEL ACTOR-CRITIC OK"),
    ("stochastic-depth/train_sd.py", ["--num-epochs", "8"],
     "STOCHASTIC DEPTH OK"),
    ("captcha/train_captcha.py", ["--num-epochs", "6"], "CAPTCHA OK"),
    ("bayesian-methods/sgld_regression.py", [], "SGLD OK"),
    ("memcost/memonger_demo.py", [], "MEMCOST REMAT OK"),
    ("capsnet/train_capsnet.py", ["--num-epochs", "6"], "CAPSNET OK"),
    ("deep-embedded-clustering/dec.py", [], "DEC OK"),
    ("cnn_chinese_text_classification/text_cnn_zh.py",
     ["--num-examples", "800", "--num-epochs", "4"],
     "final chinese text-cnn accuracy"),
]


@pytest.mark.parametrize("rel,args,line", A14_EXAMPLES,
                         ids=[r[0] for r in A14_EXAMPLES])
def test_a14_example_on_the_port(rel, args, line):
    r = _run(rel, *args)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-2000:]
    assert line in r.stdout
    if rel.startswith("cnn_chinese"):
        assert float(r.stdout.rsplit("accuracy:", 1)[1]) > 0.8
