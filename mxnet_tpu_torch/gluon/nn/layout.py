"""Construction-time default-layout scope (counterpart of
``mxnet_tpu/gluon/nn/layout.py``).

    with nn.default_layout("NHWC"):
        net = resnet50_v1()

Layers resolve their default layout at construction; an explicitly
passed ``layout=``/``axis=`` always wins.  The default is NCHW, as in
the reference; the port's convolutions take channel-last only so far.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

from ...ops.conv import CHANNEL_FIRST, CHANNEL_LAST

__all__ = ["default_layout", "is_channel_last", "resolve_layout",
           "channel_axis"]

_state = threading.local()


def _current():
    return getattr(_state, "layout", "NCHW")


@contextmanager
def default_layout(layout):
    """Scope under which conv/pool/BatchNorm layer defaults follow
    ``layout`` (None = no change)."""
    if layout is None:
        yield
        return
    if layout not in CHANNEL_LAST and layout not in CHANNEL_FIRST:
        raise ValueError(f"unknown layout {layout!r}")
    prev = _current()
    _state.layout = layout
    try:
        yield
    finally:
        _state.layout = prev


def is_channel_last(layout=None):
    return (layout if layout is not None else _current()) in CHANNEL_LAST


def resolve_layout(layout, ndim):
    """Layer-default layout for ``ndim`` spatial dims, honoring an
    explicit ``layout``."""
    if layout is not None:
        return layout
    if is_channel_last():
        return ["NWC", "NHWC", "NDHWC"][ndim - 1]
    return ["NCW", "NCHW", "NCDHW"][ndim - 1]


def channel_axis(layout=None):
    """Channel axis of a 4-d activation: 1 channel-first, -1 last."""
    return -1 if is_channel_last(layout) else 1
