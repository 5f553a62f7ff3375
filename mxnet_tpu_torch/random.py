"""``mx.random`` — seeding and the module-level samplers (counterpart of
``mxnet_tpu/random.py``; reference python/mxnet/random.py).  ``seed``
reseeds the port's per-device generators (``_rng``)."""
from __future__ import annotations

from ._rng import seed  # noqa: F401
from .ndarray.random import (  # noqa: F401
    exponential,
    gamma,
    generalized_negative_binomial,
    multinomial,
    negative_binomial,
    normal,
    normal_like,
    poisson,
    randint,
    randn,
    shuffle,
    uniform,
    uniform_like,
)
