"""Per-device random generators and step keys (counterpart of
``mxnet_tpu/_rng.py``).

The reference keeps one JAX key chain: an eager op splits the global
key, and a traced program (the train step, the graph executor) installs
a key and derives one sub-key per random op with ``fold_in``.  The port
keeps an explicit ``torch.Generator`` per device instead:

- eager ops draw from the device's generator, seeded by
  :func:`seed` (``mx.random.seed``), 0 until then;
- a **key** is an integer from which a step derives its own
  generators: inside :func:`key_scope` every random op on a device
  takes consecutive draws of one generator seeded from the key, in the
  role of ``fold_in(key, counter)``.  The same key gives the same
  masks, different keys give different ones.  :func:`split` and
  :func:`fold_in` derive new keys from a key (splitmix64), as
  ``jax.random.split``/``fold_in`` do.

:func:`draw_bernoulli` is the one function that draws a Dropout mask;
a check that feeds known masks replaces it.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["seed", "generator", "take_key", "key_scope", "draws_scope",
           "split", "fold_in", "draw_bernoulli", "generator_states",
           "set_generator_states"]

_MASK64 = (1 << 64) - 1


class _RngState(threading.local):
    """Per thread, as the reference's ``_RngState(threading.local)``
    (``mxnet_tpu/_rng.py:18``): a seed, the eager generators and the key
    scope belong to the thread that set them."""

    def __init__(self):
        self.seed = 0
        self.gens = {}      # str(device) -> the device's eager generator
        self.scope = None   # (key, {str(device): generator}) in key_scope
        self.draws = None   # device -> generator, inside draws_scope


_S = _RngState()


def _new_generator(device, value):
    g = torch.Generator(device=device)
    g.manual_seed(int(value))
    return g


def seed(seed_state, ctx="all"):
    """``mx.random.seed``: reseed the generator of every device
    (``ctx="all"``) or of one context's device."""
    if isinstance(ctx, str) and ctx == "all":
        _S.seed = int(seed_state)
        _S.gens.clear()
        return
    from .context import resolve_device

    dev = resolve_device(ctx)
    _S.gens[str(dev)] = _new_generator(dev, seed_state)


def generator(device):
    """The eager generator of ``device`` (made on first use from the
    last :func:`seed`)."""
    dev = torch.device(device)
    g = _S.gens.get(str(dev))
    if g is None:
        g = _S.gens[str(dev)] = _new_generator(dev, _S.seed)
    return g


def _mix(z):
    """splitmix64's finalizer of ``z + golden``."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(key, data):
    """A key derived from ``key`` and the integer ``data`` (63 bits)."""
    return _mix(_mix(int(key) & _MASK64) ^ (int(data) & _MASK64)) >> 1


def split(key, num=2):
    """``num`` keys derived from ``key``, as ``jax.random.split``."""
    return tuple(fold_in(key, i) for i in range(num))


def take_key(device):
    """The generator a random op on ``device`` draws from: the step's
    inside :func:`key_scope`, else the device's eager one."""
    dev = torch.device(device)
    if _S.draws is not None:
        return _S.draws(dev)
    if _S.scope is None:
        return generator(dev)
    key, gens = _S.scope
    g = gens.get(str(dev))
    if g is None:
        g = gens[str(dev)] = _new_generator(dev, key)
    return g


@contextlib.contextmanager
def key_scope(key):
    """Random ops inside draw from generators seeded by ``key`` (None:
    the reference's fixed key 0), one per device, each op taking the
    next draws."""
    prev = _S.scope
    _S.scope = (fold_in(0 if key is None else key, 0), {})
    try:
        yield
    finally:
        _S.scope = prev


@contextlib.contextmanager
def draws_scope(take):
    """Random ops inside draw from ``take(device)`` (a generator), ahead
    of any key scope: a CUDA graph's warm-up and capture draw from
    generators of their own (``gluon/_graph.py``)."""
    prev = _S.draws
    _S.draws = take
    try:
        yield
    finally:
        _S.draws = prev


def draw_bernoulli(keep, shape, device, gen):
    """A bool mask of ``shape`` on ``device``, each element True with
    probability ``keep``, drawn from ``gen`` (Dropout's mask)."""
    return torch.rand(shape, generator=gen, device=device) < keep


def generator_states():
    """``{device: state bytes}`` of every eager generator made so far."""
    return {d: g.get_state().numpy().tobytes() for d, g in _S.gens.items()}


def set_generator_states(states, seed_value=None):
    """Restore :func:`generator_states` (and the seed new devices take)."""
    if seed_value is not None:
        _S.seed = int(seed_value)
    for d, raw in states.items():
        g = generator(d)
        g.set_state(torch.frombuffer(bytearray(raw), dtype=torch.uint8))
