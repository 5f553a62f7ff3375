"""Custom-operator library loading — the MXLoadLib analog (counterpart
of ``mxnet_tpu/library.py``).

A plugin is a Python module (file path or import name) whose ops are
PyTorch functions — with hand-written CUDA kernels where it has them —
registered in the same registry every built-in op uses, so loaded ops
appear in ``mx.nd`` at once.  (The reference also exposes them in
``mx.sym``; the port's Symbol API is a later slice.)

A plugin module may either:
  * call ``mxnet_tpu_torch.ops.registry.register_op`` at import time, or
  * define ``register_ops(registry)``, called with the registry module
    after import (the lib_api.h ``initialize`` hook).

    mx.library.load("mxnet_tpu_torch/example/plugin/cuda_ops.py")
    mx.nd.plugin_scaled_add(a, b, scale=0.5)

Loading a plugin again, by the same path or name or by the other
spelling of the same file, returns the module loaded first.
"""
from __future__ import annotations

import importlib
import importlib.util
import os
import sys

from .base import MXNetError

__all__ = ["load", "compiled_with_cxx11_abi", "loaded_libraries"]

_LOADED: dict[str, object] = {}


def _loaded_from(path):
    """The plugin module already loaded from file ``path``, or None."""
    path = os.path.abspath(path)
    for mod in _LOADED.values():
        f = getattr(mod, "__file__", None)
        if f is not None and os.path.abspath(f) == path:
            return mod
    return None


def load(path, verbose=True):
    """Load an operator plugin (reference MXLoadLib, library.py:29).

    ``path``: a ``.py`` file path or an importable module name.
    Returns the loaded module; ops it registers become visible in the
    ``mx.nd`` namespace right away.
    """
    from .ops import registry as _registry

    is_file = os.path.isfile(path)
    key = os.path.abspath(path) if is_file else path
    first = _LOADED.get(key) or (_loaded_from(path) if is_file else None)
    if first is not None:
        _LOADED[key] = first
        return first
    before = set(_registry.list_ops())
    if is_file:
        name = "_mx_plugin_" + os.path.splitext(os.path.basename(path))[0]
        spec = importlib.util.spec_from_file_location(name, path)
        if spec is None or spec.loader is None:
            raise MXNetError(f"cannot load library {path!r}")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except Exception as e:
            sys.modules.pop(name, None)
            raise MXNetError(
                f"library {path!r} failed to initialize: {e}") from e
    else:
        try:
            mod = importlib.import_module(path)
        except ImportError as e:
            raise MXNetError(
                f"{path!r} is neither a file nor an importable "
                f"module: {e}") from e
        first = _loaded_from(mod.__file__) \
            if getattr(mod, "__file__", None) else None
        if first is not None:
            _LOADED[key] = first
            return first
    hook = getattr(mod, "register_ops", None)
    if callable(hook):
        hook(_registry)
    new_ops = sorted(set(_registry.list_ops()) - before)
    if not new_ops:
        raise MXNetError(
            f"library {path!r} registered no operators (define "
            "register_ops(registry) or call register_op at import)")
    from . import ndarray as _nd
    from .symbol import _op_namespace as _symns

    _nd._expose_new_ops()
    _symns._expose_new_ops()
    if verbose:
        print(f"[mx.library] loaded {path!r}: {', '.join(new_ops)}")
    _LOADED[key] = mod
    return mod


def loaded_libraries():
    return dict(_LOADED)


def compiled_with_cxx11_abi():
    """Reference library.py surface; op plugins are Python modules here,
    with no C++ ABI boundary."""
    return False
