"""The model zoo's vision networks the port carries: ResNet v1/v2 and VGG
(reference `python/mxnet/gluon/model_zoo/vision/__init__.py`).  Weights
are random; ``pretrained=True`` raises, since nothing is downloaded."""
from .resnet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
from . import resnet as _resnet, vgg as _vgg


def get_model(name, **kwargs):
    """A network by its model-zoo name (``resnet50_v1``, ``vgg16_bn``)."""
    models = {n: getattr(mod, n) for mod in (_resnet, _vgg)
              for n in mod.__all__ if n.startswith(("resnet", "vgg"))}
    name = name.lower()
    if name not in models:
        raise ValueError(f"Model {name} is not supported. Available: "
                         f"{sorted(models)}")
    return models[name](**kwargs)
