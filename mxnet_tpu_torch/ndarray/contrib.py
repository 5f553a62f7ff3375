"""``mx.nd.contrib`` (counterpart of ``mxnet_tpu/ndarray/contrib.py``):
every registered ``_contrib_*`` op under its short name
(``mx.nd.contrib.MultiBoxTarget``).  The control-flow operators
``foreach``, ``while_loop`` and ``cond`` wait for the port's
``ops/control_flow_ops.py`` (ROADMAP §A 7) and raise."""
from __future__ import annotations

import sys

from ..base import MXNetError
from ..ops.registry import get_op, list_ops
from . import _make_op_func

_this = sys.modules[__name__]


def _expose_contrib():
    for name in list_ops():
        if name.startswith("_contrib_"):
            short = name[len("_contrib_"):]
            if short.isidentifier() and not hasattr(_this, short):
                setattr(_this, short, _make_op_func(get_op(name), short))


def _control_flow(name):
    def refuse(*args, **kwargs):
        raise MXNetError(f"mx.nd.contrib.{name} is not ported yet: the "
                         "control-flow operators wait for "
                         "ops/control_flow_ops.py (ROADMAP §A 7)")

    refuse.__name__ = name
    return refuse


foreach = _control_flow("foreach")
while_loop = _control_flow("while_loop")
cond = _control_flow("cond")

_expose_contrib()
