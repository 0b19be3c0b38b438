"""The examples that the rest of ``ops/nn.py``, ``gluon.nn``, ``metric``
and ``gluon.loss.CTCLoss`` unblocked, written for the JAX package, run on
the port with one import changed (`mxnet_tpu_torch/tools/run_example.py`),
on the CPU.

Each runs in a subprocess (``python -m mxnet_tpu_torch.tools.run_example
EXAMPLE --device cpu ARGS``), so that the check that neither ``jax`` nor
``mxnet_tpu`` was imported sees a process of its own, at the arguments
of its JAX test in `tests/test_examples.py`, and must print the line
that test asserts: ``SVMOutput`` (svm_mnist), ``LogisticRegressionOutput``
and ``metric.np`` (kaggle-ndsb2), ``Deconvolution`` (fcn-xs),
``Conv2DTranspose`` (the adversarial VAE), ``gluon.loss.CTCLoss`` (the
OCR example) and ``CTCLoss`` under ``BucketingModule`` (the speech
acoustic model).
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


A7_EXAMPLES = [
    ("svm_mnist/train_svm.py", ["--num-examples", "800", "--num-epochs", "6"],
     "final svm accuracy"),
    ("kaggle-ndsb2/train_ndsb2.py",
     ["--num-examples", "200", "--num-epochs", "6"], "final NDSB2 val CRPS"),
    ("fcn-xs/train_fcn.py", ["--num-examples", "32", "--num-epochs", "10"],
     "FCN SEGMENTATION OK"),
    ("mxnet_adversarial_vae/vaegan.py",
     ["--num-examples", "512", "--num-epochs", "6", "--batch-size", "32"],
     "final VAE-GAN pixel recon MSE"),
    ("ctc/train_ctc_ocr.py", ["--num-examples", "800", "--num-epochs", "25"],
     "sequence accuracy"),
    ("speech_recognition/train_am.py", [], "SPEECH AM OK"),
]


@pytest.mark.parametrize("rel,args,line", A7_EXAMPLES,
                         ids=[r[0] for r in A7_EXAMPLES])
def test_a7_example_on_the_port(rel, args, line):
    r = _run(rel, *args)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-2000:]
    assert line in r.stdout
