"""Gluon (counterpart of ``mxnet_tpu/gluon``): blocks and parameters
(deferred shapes and ``params=`` sharing included), the layers of the
classification zoo and of the recurrent models (``nn.Embedding``,
``nn.Sequential``, ``nn.Lambda``), ``hybridize`` (a shape-keyed cache,
captured as CUDA graphs with both static flags), the symbolic trace,
``HybridBlock.export`` and ``SymbolBlock``, the recurrent layers and cells
(``rnn``), the softmax cross-entropy loss, the model zoo, the
``Trainer`` and ``gluon.data``."""
from . import data, loss, model_zoo, nn, rnn, trainer  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .parameter import (Constant, DeferredInitializationError,  # noqa: F401
                        Parameter, ParameterDict)
from .trainer import Trainer  # noqa: F401

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Parameter", "Constant",
           "ParameterDict",
           "DeferredInitializationError", "Trainer", "data", "loss",
           "model_zoo", "nn", "rnn", "trainer"]
