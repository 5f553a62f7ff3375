"""Dynamic loss scaler (counterpart of
``mxnet_tpu/contrib/amp/loss_scaler.py``).

The scale doubles after ``scale_window`` consecutive overflow-free
steps and halves on overflow (never below 1); overflow is the
``multi_all_finite`` op over the gradients, read once a step.
"""
from __future__ import annotations

import logging


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = float(init_scale)
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0

    def has_overflow(self, params):
        """True when any gradient of ``params`` is non-finite."""
        from ...ops.contrib_ops import multi_all_finite

        grads = []
        for p in params:
            if p.grad_req == "null" or not p._initialized:
                continue
            g = p._wrap()._grad
            if g is not None:
                grads.append(g._data)
        if not grads:
            return False
        ok = multi_all_finite(*grads, num_arrays=len(grads))
        return float(ok[0]) == 0.0

    def update_scale(self, overflow):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
            logging.info("AMP: gradient overflow, lowering loss scale to "
                         "%g", self.loss_scale)
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
