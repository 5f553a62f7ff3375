"""Vision models (counterpart of ``mxnet_tpu/gluon/model_zoo/vision``):
ResNet v1 and v2, and ``get_model`` over their names."""
from ....base import MXNetError
from .resnet import *  # noqa: F401,F403
from .resnet import __all__ as _resnet_all

__all__ = list(_resnet_all) + ["get_model"]

#: name -> constructor, the reference's names of the ported models
_models = {f"resnet{n}_v{v}": globals()[f"resnet{n}_v{v}"]
           for v in (1, 2) for n in (18, 34, 50, 101, 152)}


def get_model(name, **kwargs):
    """A model by its name in the reference's zoo (reference
    ``get_model``, ``mxnet_tpu/gluon/model_zoo/vision/__init__.py:62``);
    ``kwargs`` go to its constructor."""
    key = name.lower()
    if key not in _models:
        raise MXNetError(f"Model {name} is not supported. Available: "
                         f"{sorted(_models)}")
    return _models[key](**kwargs)
