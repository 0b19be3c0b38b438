"""Vision models of the port's model zoo (reference
`python/mxnet/gluon/model_zoo/vision/__init__.py`): the ResNet family,
v1 and v2, by name through ``get_model``. AlexNet, VGG, SqueezeNet,
MobileNet, DenseNet and Inception are not ported yet."""
from .resnet import *  # noqa: F401,F403
from .resnet import (get_resnet, resnet18_v1, resnet34_v1, resnet50_v1,
                     resnet101_v1, resnet152_v1, resnet18_v2, resnet34_v2,
                     resnet50_v2, resnet101_v2, resnet152_v2)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
}


def get_model(name, **kwargs):
    name = name.lower()
    if name not in _models:
        raise ValueError("Model %s is not supported. Available options "
                         "are\n\t%s" % (name, "\n\t".join(sorted(_models))))
    return _models[name](**kwargs)
