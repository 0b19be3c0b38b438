"""The port stands alone: no file of ``mxnet_tpu_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, and the port calls no
finished LSTM (cuDNN through ``torch.nn.LSTM`` or ``_VF.lstm``) and no
``torch.compile``; ``chip_smoke.py`` may time ``torch.nn.LSTM`` as a
yardstick."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py"))
FORBIDDEN_ROOTS = {"jax", "jaxlib", "mxnet_tpu"}
FORBIDDEN_CALLS = ("nn.LSTM", "_VF.lstm", "torch.compile", "cudnn_rnn")


def _rel(path):
    return str(path.relative_to(ROOT))


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", None) == "__import__" and \
                node.args and isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


GLUON_TRAINING = ["autograd.py", "ops/reduce.py", "gluon/loss.py",
                  "gluon/trainer.py", "gluon/utils.py",
                  "gluon/data/__init__.py", "gluon/data/dataset.py",
                  "gluon/data/sampler.py", "gluon/data/dataloader.py"]
ND_CORE = ["ops/init_ops.py", "tools/run_example.py"]
SPARSE = ["kvstore.py", "ndarray/sparse.py", "ops/compat_ops.py",
          "ops/sparse_update.py"]


def test_port_files_found():
    assert len(PORT_FILES) >= 20
    assert (ROOT / "mxnet_tpu_torch" / "csrc" / "fused_lstm.cu").exists()
    port = {str(p.relative_to(ROOT / "mxnet_tpu_torch")) for p in PORT_FILES}
    assert set(GLUON_TRAINING) <= port
    assert set(ND_CORE) <= port
    assert set(SPARSE) <= port
    assert (ROOT / "mxnet_tpu_torch" / "csrc" /
            "sparse_row_update.cu").exists()
    from mxnet_tpu_torch.ops import _build
    assert "sparse_row_update" in _build.SOURCES


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=_rel)
def test_no_jax_imports(path):
    assert not _imported_roots(path) & FORBIDDEN_ROOTS


@pytest.mark.parametrize("path", PORT_FILES, ids=_rel)
def test_no_finished_kernels(path):
    text = path.read_text()
    for name in FORBIDDEN_CALLS:
        assert name not in text, "%s uses %s" % (_rel(path), name)
