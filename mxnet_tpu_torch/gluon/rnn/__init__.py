"""Recurrent layers and cells (counterpart of ``mxnet_tpu/gluon/rnn``):
``RNN``/``LSTM``/``GRU`` over the fused RNN op (cuDNN on the card), and
the cells with ``unroll``."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403
