"""Examples written for the JAX package, run on the port with one import
changed (`mxnet_tpu_torch/tools/run_example.py`), on the CPU.

Each example runs in a subprocess (``python -m
mxnet_tpu_torch.tools.run_example EXAMPLE --device cpu ARGS``), so that
the check that neither ``jax`` nor ``mxnet_tpu`` was imported sees a
process of its own, with the arguments of its JAX test in
`tests/test_examples.py` (the five Adam examples at smaller ones), and
must print the line that test asserts: the detection slice's SSD,
Faster-RCNN (plain, and ``--ohem --deformable``) and ``custom_softmax``
examples too.
The rewriting itself is held here too.
"""
import os
import subprocess
import sys

import pytest

from mxnet_tpu_torch.tools.run_example import rewrite, run_example

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXAMPLES = os.path.join(ROOT, "examples")


def _run(rel, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.run_example",
         os.path.join(EXAMPLES, rel), "--device", "cpu"] + list(args),
        capture_output=True, text=True, env=env, timeout=timeout, cwd=ROOT)


def test_adversary_fgsm_on_the_port():
    r = _run("adversary/fgsm_mnist.py", "--num-examples", "600",
             "--num-epochs", "3")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "adversarial accuracy" in r.stdout


def test_gluon_resnet_tiny_on_the_port():
    r = _run("gluon/train_resnet50.py", "--model", "resnet18_v1",
             "--batch-size", "2", "--image-size", "32",
             "--num-classes", "10", "--num-batches", "2", "--ctx", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "img/s" in r.stdout


#: the Gluon examples that train with Adam, each at the smallest arguments
#: that still print the line its JAX test in tests/test_examples.py asserts
ADAM_EXAMPLES = [
    ("vae/train_vae.py", ["--num-examples", "500", "--num-epochs", "8"],
     "VAE TRAINING OK"),
    ("gan/train_gan.py", ["--num-iters", "150"], "sample mean"),
    ("autoencoder/train_autoencoder.py",
     ["--num-examples", "600", "--num-epochs", "12"],
     "final reconstruction loss"),
    ("recommenders/train_mf.py", ["--num-epochs", "8"], "final test mse"),
    ("cnn_text_classification/train_cnn_text.py",
     ["--num-examples", "600", "--num-epochs", "3"],
     "final text-cnn accuracy"),
]


@pytest.mark.parametrize("rel,args,line", ADAM_EXAMPLES,
                         ids=[e[0].split("/")[0] for e in ADAM_EXAMPLES])
def test_adam_example_on_the_port(rel, args, line):
    r = _run(rel, *args)
    assert r.returncode == 0, r.stderr[-2000:]
    assert line in r.stdout


#: the detection slice's examples at their JAX tests' arguments
DETECTION_EXAMPLES = [
    ("ssd/train_ssd.py", ["--num-batches", "30", "--batch-size", "8"],
     "detections kept after NMS"),
    ("rcnn/train_faster_rcnn.py", ["--num-steps", "20"],
     "FASTER-RCNN FLOW OK"),
    ("rcnn/train_faster_rcnn.py", ["--num-steps", "10", "--ohem",
                                   "--deformable"], "FASTER-RCNN FLOW OK"),
    ("numpy-ops/custom_softmax.py", ["--num-epochs", "8"],
     "CUSTOM NUMPY OP OK"),
]


@pytest.mark.parametrize("rel,args,line", DETECTION_EXAMPLES,
                         ids=["ssd", "faster_rcnn", "faster_rcnn_ohem_deform",
                              "custom_softmax"])
def test_detection_example_on_the_port(rel, args, line):
    r = _run(rel, *args)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-2000:]
    assert line in r.stdout


def test_rewrite_changes_only_the_imports():
    src = ("import numpy as np\n"
           "import mxnet_tpu as mx\n"
           "from mxnet_tpu import autograd, gluon\n"
           "    from mxnet_tpu.gluon.model_zoo import vision\n"
           "x = mx.nd.ones((2,))  # mxnet_tpu_torch is fine\n")
    assert rewrite(src) == src.replace("mxnet_tpu ", "mxnet_tpu_torch ") \
        .replace("mxnet_tpu.gluon", "mxnet_tpu_torch.gluon")


@pytest.mark.parametrize("line", [
    "import mxnet_tpu\n", "import mxnet_tpu.ndarray as nd\n",
    "from mxnet_tpu.ops import pallas_kernels as pk, mxnet_tpu\n",
    "print(mxnet_tpu.__file__)\n", "# see mxnet_tpu/ops\n"])
def test_rewrite_refuses_any_other_mention(line):
    with pytest.raises(ValueError, match="names mxnet_tpu"):
        rewrite("import mxnet_tpu as mx\n" + line, "ex.py")


def test_run_example_fails_where_jax_is_loaded(tmp_path):
    """Under pytest the test harness has imported JAX, so the run's
    check fails (the subprocess cases above are clean)."""
    path = tmp_path / "ex.py"
    path.write_text("import mxnet_tpu as mx\n"
                    "assert mx.current_context() == mx.cpu()\n"
                    "print(mx.nd.ones((2,)).sum().asscalar())\n")
    assert "jax" in sys.modules
    with pytest.raises(RuntimeError, match="imported jax"):
        run_example(str(path), device="cpu")


def test_run_example_refuses_an_unknown_device(tmp_path):
    path = tmp_path / "ex.py"
    path.write_text("import mxnet_tpu as mx\n")
    with pytest.raises(ValueError, match="device"):
        run_example(str(path), device="tpu")


@pytest.mark.parametrize("call", ["function", "command line"])
def test_run_example_runs_on_the_card_by_default(tmp_path, monkeypatch,
                                                 call):
    """Without ``--device`` an example runs under ``gpu(0)``: on a host
    without that card it raises before the script runs."""
    from mxnet_tpu_torch import context
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.tools.run_example import main

    monkeypatch.setattr(context, "num_gpus", lambda: 0)
    path = tmp_path / "ex.py"
    path.write_text("import mxnet_tpu as mx\nraise SystemExit('ran')\n")
    with pytest.raises(MXNetError, match="gpu\\(0\\) needs CUDA device 0"):
        if call == "function":
            run_example(str(path))
        else:
            main([str(path)])
