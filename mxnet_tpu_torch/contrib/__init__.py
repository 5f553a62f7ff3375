"""Contrib packages (counterpart of ``mxnet_tpu/contrib``): ``amp`` and
``quantization``.  The reference's ``onnx``, ``svrg_optimization``,
``tensorboard`` and ``text`` are not ported yet (ROADMAP §A 13).

``amp`` is imported at once (the op registry reads its policy lists);
``quantization``, which needs Gluon, on first use."""
import importlib

from . import amp  # noqa: F401

__all__ = ["amp", "quantization"]


def __getattr__(name):
    if name == "quantization":
        return importlib.import_module(f"{__name__}.quantization")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
