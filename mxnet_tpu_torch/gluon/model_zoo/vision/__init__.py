"""Vision models of the port's model zoo (counterpart of
`mxnet_tpu/gluon/model_zoo/vision/__init__.py`, reference
`python/mxnet/gluon/model_zoo/vision/__init__.py`): ResNet v1 and v2,
AlexNet, VGG (with the ``_bn`` variants), SqueezeNet, MobileNet v1 and v2,
DenseNet and Inception-v3, the JAX package's 34 names through
``get_model``, with its parameter names. ``pretrained=True`` loads the
model's weights file from ``root`` or ``$MXNET_TPU_MODEL_DIR``
(`model_store`), and raises where there is none."""
from .resnet import *  # noqa: F401,F403
from .alexnet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .resnet import (get_resnet, resnet18_v1, resnet34_v1, resnet50_v1,
                     resnet101_v1, resnet152_v1, resnet18_v2, resnet34_v2,
                     resnet50_v2, resnet101_v2, resnet152_v2)
from .alexnet import alexnet
from .vgg import (get_vgg, vgg11, vgg13, vgg16, vgg19, vgg11_bn, vgg13_bn,
                  vgg16_bn, vgg19_bn)
from .squeezenet import get_squeezenet, squeezenet1_0, squeezenet1_1
from .mobilenet import (get_mobilenet, get_mobilenet_v2, mobilenet1_0,
                        mobilenet0_75, mobilenet0_5, mobilenet0_25,
                        mobilenet_v2_1_0, mobilenet_v2_0_75,
                        mobilenet_v2_0_5, mobilenet_v2_0_25)
from .densenet import (get_densenet, densenet121, densenet161, densenet169,
                       densenet201)
from .inception import inception_v3

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "alexnet": alexnet,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0,
    "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5,
    "mobilenetv2_0.25": mobilenet_v2_0_25,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "inceptionv3": inception_v3,
}


def get_model(name, **kwargs):
    name = name.lower()
    if name not in _models:
        raise ValueError("Model %s is not supported. Available options "
                         "are\n\t%s" % (name, "\n\t".join(sorted(_models))))
    return _models[name](**kwargs)
