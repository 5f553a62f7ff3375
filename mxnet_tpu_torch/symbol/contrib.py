"""``mx.sym.contrib`` (counterpart of ``mxnet_tpu/symbol/contrib.py``):
the control-flow operators ``foreach``, ``while_loop`` and ``cond`` need
the port's ``ops/control_flow_ops.py`` (ROADMAP §A 7).  Every name
raises until then."""
from ..base import MXNetError


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise MXNetError(f"mx.sym.contrib.{name} is not ported yet: the "
                     "control-flow operators wait for "
                     "ops/control_flow_ops.py (ROADMAP §A 7)")
