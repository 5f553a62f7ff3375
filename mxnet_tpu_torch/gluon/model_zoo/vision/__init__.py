"""Vision models (counterpart of ``mxnet_tpu/gluon/model_zoo/vision``):
ResNet v1 and v2, VGG, AlexNet, DenseNet, SqueezeNet, Inception v3,
MobileNet v1 and v2, LeNet, the SSD detectors (SSD-300 and SSD-512 on
VGG16-reduced, SSD-300 on ResNet-18), and ``get_model`` over the
reference's names."""
from ....base import MXNetError
from .alexnet import *  # noqa: F401,F403
from .alexnet import __all__ as _alexnet_all
from .densenet import *  # noqa: F401,F403
from .densenet import __all__ as _densenet_all
from .inception import *  # noqa: F401,F403
from .inception import __all__ as _inception_all
from .lenet import *  # noqa: F401,F403
from .lenet import __all__ as _lenet_all
from .mobilenet import *  # noqa: F401,F403
from .mobilenet import __all__ as _mobilenet_all
from .resnet import *  # noqa: F401,F403
from .resnet import __all__ as _resnet_all
from .squeezenet import *  # noqa: F401,F403
from .squeezenet import __all__ as _squeezenet_all
from .ssd import *  # noqa: F401,F403
from .ssd import __all__ as _ssd_all
from .vgg import *  # noqa: F401,F403
from .vgg import __all__ as _vgg_all

__all__ = (list(_alexnet_all) + list(_densenet_all) + list(_inception_all)
           + list(_lenet_all) + list(_mobilenet_all) + list(_resnet_all)
           + list(_squeezenet_all) + list(_ssd_all) + list(_vgg_all)
           + ["get_model"])

#: name -> constructor, the reference's names of the ported models
_models = {f"resnet{n}_v{v}": globals()[f"resnet{n}_v{v}"]
           for v in (1, 2) for n in (18, 34, 50, 101, 152)}
_models.update({f"vgg{n}{bn}": globals()[f"vgg{n}{bn}"]
                for n in (11, 13, 16, 19) for bn in ("", "_bn")})
_models.update({
    "alexnet": alexnet,
    "densenet121": densenet121,
    "densenet161": densenet161,
    "densenet169": densenet169,
    "densenet201": densenet201,
    "squeezenet1.0": squeezenet1_0,
    "squeezenet1.1": squeezenet1_1,
    "inceptionv3": inception_v3,
    "mobilenet1.0": mobilenet1_0,
    "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5,
    "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0,
    "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5,
    "mobilenetv2_0.25": mobilenet_v2_0_25,
    "lenet": lenet,
    "ssd_300_vgg16_reduced": ssd_300_vgg16_reduced,
    "ssd_512_vgg16": ssd_512_vgg16,
    "ssd_300_resnet18": ssd_300_resnet18,
})


def get_model(name, **kwargs):
    """A model by its name in the reference's zoo (reference
    ``get_model``, ``mxnet_tpu/gluon/model_zoo/vision/__init__.py:62``);
    ``kwargs`` go to its constructor."""
    key = name.lower()
    if key not in _models:
        raise MXNetError(f"Model {name} is not supported. Available: "
                         f"{sorted(_models)}")
    return _models[key](**kwargs)
