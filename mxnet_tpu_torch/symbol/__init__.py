"""``mx.sym`` — the symbolic front end (counterpart of
``mxnet_tpu/symbol/``; reference: python/mxnet/symbol/)."""
from .symbol import *  # noqa: F401,F403
from .symbol import (  # noqa: F401
    AttrScope, Symbol, Variable, var, Group, load, load_json)
from . import _op_namespace  # noqa: F401  (populates sym.<Op> functions)
from ._op_namespace import *  # noqa: F401,F403
from . import contrib  # noqa: E402,F401  (raises: not ported yet)
