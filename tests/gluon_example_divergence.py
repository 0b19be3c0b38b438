"""The loss of `examples/gluon/train_resnet50.py`'s loop at its defaults
(lr 0.1, momentum 0.9, wd 1e-4, Xavier(magnitude=2), batch 32, one
repeated batch), in the JAX package and in the port, on the CPU.

Both fall at the first update and then climb: the example's learning
rate at batch 32 overshoots. The images are 64x64 here, not 224x224, to
keep the run short; ResNet-50 v1 and everything else are the example's.
Run from the repository root::

    JAX_PLATFORMS=cpu MXNET_XLA_STATS=0 python tests/gluon_example_divergence.py

It prints one line per step (about 3 s a step on 8 cores after a minute
of compilation). It is not a test: pytest does not collect it.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import autograd, gluon  # noqa: E402
from mxnet_tpu.gluon.model_zoo import vision as jvision  # noqa: E402
import mxnet_tpu_torch as mxt  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision  # noqa: E402

BATCH, SIZE, STEPS = 32, 64, 8
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def main():
    cpu = mxt.cpu()
    shape = (BATCH, 3, SIZE, SIZE)
    np.random.seed(0)
    tnet = tvision.resnet50_v1(classes=1000)
    tnet.initialize(mxt.init.Xavier(magnitude=2), ctx=cpu)
    tnet(mxt.nd.zeros(shape, ctx=cpu))
    jnet = jvision.resnet50_v1(classes=1000, prefix=tnet.prefix)
    jnet.initialize(mx.init.Xavier(magnitude=2), ctx=mx.cpu())
    jnet(mx.nd.zeros(shape))
    for name, param in jnet.collect_params().items():
        param.set_data(mx.nd.array(
            tnet.collect_params()[name].data().asnumpy()))
    tnet.hybridize()
    jnet.hybridize()
    jtrainer = gluon.Trainer(jnet.collect_params(), "sgd", dict(OPT))
    ttrainer = mxt.gluon.Trainer(tnet.collect_params(), "sgd", dict(OPT))
    jloss = gluon.loss.SoftmaxCrossEntropyLoss()
    tloss = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(0)
    x = rng.rand(*shape).astype(np.float32)
    y = rng.randint(0, 1000, BATCH).astype(np.float32)
    jx, jy = mx.nd.array(x), mx.nd.array(y)
    tx, ty = mxt.nd.array(x, ctx=cpu), mxt.nd.array(y, ctx=cpu)
    for step in range(STEPS):
        with autograd.record():
            jl = jloss(jnet(jx), jy)
        jl.backward()
        jtrainer.step(BATCH)
        with mxt.autograd.record():
            tl = tloss(tnet(tx), ty)
        tl.backward()
        ttrainer.step(BATCH)
        print("step %d loss: jax %.4f port %.4f"
              % (step, jl.asnumpy().mean(), tl.asnumpy().mean()), flush=True)


if __name__ == "__main__":
    main()
