"""DenseNet-121 at 224 x 224 and Inception-v3 at 299 x 299 on the port
against the JAX package, on the CPU: an eager forward at batch 1 from the
JAX net's Xavier weights carried across by ``weights.set_block_params``,
logits at rtol 1e-4, atol 1e-5 of their largest magnitude (f32 on both
sides; the convolutions sum in other orders through ~120 layers), and
the port's hybridized call against its eager one. See
`test_torch_zoo.py`; they are a file of their own because each JAX net
compiles for 15-40 s.
"""
import pytest

from test_torch_zoo import check_family


@pytest.fixture(autouse=True)
def _no_xla_stats(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


@pytest.mark.parametrize("name,size", [("densenet121", 224),
                                       ("inceptionv3", 299)])
def test_family_forward_matches_jax(name, size):
    check_family(name, size)
