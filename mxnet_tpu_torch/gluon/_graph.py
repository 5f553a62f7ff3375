"""The CUDA-graph program of one cache entry of a hybridized block.

The reference keeps its CachedOp program inside ``HybridBlock``
(``mxnet_tpu/gluon/block.py:531-700``): one compiled program per input
signature, differentiated as one tape node.  With ``hybridize(
static_alloc=True, static_shape=True)`` on a CUDA device, upstream MXNet
1.x captures that program in CUDA graphs; so does the port.  A
:class:`GraphProgram` is built from ``fn``, the block's forward on flat
tensors, and one example call:

- **warm-up**: ``fn`` (and, for a recording entry, its backward) runs
  on a side stream, so that cuDNN, cuBLAS and the hand-written kernels
  make their workspaces and lazy state before capture.  It runs under
  torch's sync debug mode set to ``error``, so that a host sync raises
  there, naming the op.  The tensors the forward writes in place
  (BatchNorm's running statistics) are put back afterwards, and its
  random draws come from generators of the program's own, so the
  warm-up leaves no trace;
- **capture**: the forward alone, or the forward and then its backward
  (``torch.autograd.grad`` of the outputs with respect to the inputs
  that require grad and the trained parameters), both on one memory
  pool.  Warm-up and capture differentiate aliases of the parameters
  (the same memory, leaves of their own), so that no autograd node of
  a parameter made outside the capture (a held replay's) joins it.
  Parameters and buffers are read by address: an optimizer's
  in-place update is seen by the next replay, and a replaced tensor
  makes the block drop the entry (``HybridBlock._call_cached``);
- **replay**: the inputs are copied into the static input buffers, the
  forward graph replays, and the outputs are handed back as copies, so
  a tensor the caller keeps is not overwritten by the next replay.  A
  recording entry is one ``torch.autograd.Function``, one tape node as
  the reference's ``jit:{name}`` node; its backward copies the output
  gradients into static buffers, replays the backward graph and hands
  back copies of the gradients.  The pool holds the activations of the
  last recorded replay, for its one backward: :meth:`GraphProgram.held`
  says whether that replay's tape node still lives with its backward
  not yet run, and a held program is not replayed (the block's entry
  captures another program instead).  A second backward of one replay
  raises.

Capture beside other threads: warm-up turns torch's sync debug mode to
``error`` for the whole process, and ``torch.cuda.graph`` captures in
the ``global`` error mode, where a CUDA call of another thread (an
allocation, a sync, a copy) fails the capture or fails itself.  So a
program is built under :data:`device_lock` held exclusively, and every
thread that works on the card while others may capture (the serving
batchers, the generative scheduler) holds it shared around its device
work: between two batches a capture waits for the running ones, and
they wait for it.

A random op draws from a generator of the program's own, registered
with the forward graph.  Before each replay that generator takes the
state of the generator the op would draw from eagerly (the device's, or
the key scope's, ``_rng.take_key``), and gives the advanced state back
after: replays draw fresh masks, equal keys give equal masks, and the
masks are the ones an eager call draws.  Where PyTorch cannot register a
generator with a graph, a block with a random op raises.
"""
from __future__ import annotations

import contextlib
import os
import threading
import traceback
import weakref

import torch

from .. import _rng
from ..base import MXNetError

__all__ = ["GraphProgram", "captures", "device_lock"]

#: warm-up passes before the capture
WARMUP = 2
#: graphs captured by this process (a recording entry's forward and
#: backward count once)
captures = 0

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class DeviceLock:
    """A process-wide reader-writer lock over the card: ``shared()`` for
    device work, ``exclusive()`` for a capture.  Both nest in one
    thread; a thread that holds it shared and asks for it exclusively
    gives its shared hold up while it waits and takes it back after, so
    two such threads cannot deadlock.  A waiting capture keeps new
    shared holders out, so it is not starved by a busy batcher."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = {}       # thread id -> shared depth
        self._writer = None      # thread id of the exclusive holder
        self._depth = 0          # its exclusive depth
        self._waiting = 0        # threads waiting to hold it exclusively

    @contextlib.contextmanager
    def shared(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer != me and me not in self._readers:
                self._cond.wait_for(lambda: self._writer is None
                                    and not self._waiting)
            self._readers[me] = self._readers.get(me, 0) + 1
        try:
            yield
        finally:
            with self._cond:
                self._readers[me] -= 1
                if not self._readers[me]:
                    del self._readers[me]
                self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        me = threading.get_ident()
        with self._cond:
            held = self._readers.pop(me, 0)
            if self._writer != me:
                self._waiting += 1
                self._cond.wait_for(lambda: self._writer is None
                                    and not self._readers)
                self._waiting -= 1
                self._writer = me
            self._depth += 1
        try:
            yield
        finally:
            with self._cond:
                self._depth -= 1
                if not self._depth:
                    self._writer = None
                if held:
                    self._readers[me] = held
                self._cond.notify_all()


#: the lock every capture takes exclusively (module docstring)
device_lock = DeviceLock()


def _where(err):
    """The innermost frame of ``err``'s traceback inside the package:
    the op at which warm-up or capture failed."""
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if f.filename.startswith(_PKG_DIR)
              and not f.filename.endswith("_graph.py")]
    if not frames:
        return "an op outside the package"
    f = frames[-1]
    return f"{f.name} ({os.path.relpath(f.filename, _PKG_DIR)}:{f.lineno})"


class GraphProgram:
    """The captured forward (and backward) of one signature.

    ``fn(aliases, *inputs)`` returns the block's outputs as a flat list
    of tensors, computed with ``aliases`` in place of ``params``.
    ``inputs`` are the example inputs (the static input buffers are
    copies of them); ``params`` the trained parameter tensors the
    backward differentiates; ``state`` the tensors the forward writes in
    place.  ``record`` captures the backward too."""

    def __init__(self, fn, inputs, params, state, record, name):
        global captures
        self.name = name
        self.record = record
        self._device = inputs[0].device
        self._gens = {}  # str(device) -> the program's generator
        self._frozen = False
        with torch.no_grad():
            self._static_in = [x.detach().clone() for x in inputs]
        for s, x in zip(self._static_in, inputs):
            s.requires_grad_(x.requires_grad)
        self._params = list(params)
        self._alias = [p.detach().requires_grad_() for p in self._params]
        self._diff = [t for t in self._static_in if t.requires_grad] \
            + self._alias
        # a weak reference to the token of the recorded replay whose
        # activations the pool holds, until its backward runs
        self._pending = None
        with device_lock.exclusive(), torch.cuda.device(self._device):
            self._warm_up(fn, state)
            self._capture(fn)
            captures += 1

    # ------------------------------------------------------------ build
    def _take(self, dev):
        """The generator a random op on ``dev`` draws from in warm-up
        and capture."""
        g = self._gens.get(str(dev))
        if g is None:
            if self._frozen:
                raise MXNetError(f"{self.name}: a random op drew on {dev} "
                                 "in capture but not in warm-up")
            g = self._gens[str(dev)] = torch.Generator(device=dev)
        return g

    def _fail(self, stage, err):
        return MXNetError(
            f"{self.name}: cannot be captured as a CUDA graph "
            f"(hybridize(static_alloc=True, static_shape=True)): {stage} "
            f"failed at {_where(err)}: {type(err).__name__}: {err}")

    def _grads(self, outs, gouts):
        pairs = [(o, g) for o, g in zip(outs, gouts) if o.requires_grad]
        return torch.autograd.grad([o for o, _ in pairs], self._diff,
                                   [g for _, g in pairs], allow_unused=True)

    def _warm_up(self, fn, state):
        with torch.no_grad():
            saved = [t.detach().clone() for t in state]
        main = torch.cuda.current_stream(self._device)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(main)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side), _rng.draws_scope(self._take):
                for _ in range(WARMUP):
                    outs = fn(self._alias, *self._static_in)
                    if self.record and self._diff:
                        self._grads(outs, [torch.ones_like(o) for o in outs])
                    del outs
        except MXNetError:
            raise
        except Exception as err:
            raise self._fail("warm-up", err) from err
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        main.wait_stream(side)
        with torch.no_grad():
            for t, v in zip(state, saved):
                t.copy_(v)

    def _capture(self, fn):
        self._frozen = True
        self._fwd = torch.cuda.CUDAGraph()
        if self._gens:
            register = getattr(self._fwd, "register_generator_state", None)
            if register is None:
                raise MXNetError(
                    f"{self.name}: cannot be captured as a CUDA graph: a "
                    f"random op (Dropout's mask, _rng.draw_bernoulli) "
                    f"draws, and this PyTorch ({torch.__version__}) cannot "
                    "register a generator with a graph")
            for g in self._gens.values():
                register(g)
        try:
            with _rng.draws_scope(self._take), torch.cuda.graph(self._fwd):
                outs = list(fn(self._alias, *self._static_in))
        except Exception as err:
            raise self._fail("forward capture", err) from err
        self._rg = [i for i, o in enumerate(outs) if o.requires_grad]
        if self.record and self._rg and self._diff:
            self._gout = [torch.empty_like(outs[i]) for i in self._rg]
            self._bwd = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(self._bwd, pool=self._fwd.pool()):
                    gin = self._grads([outs[i] for i in self._rg],
                                      self._gout)
            except Exception as err:
                raise self._fail("backward capture", err) from err
            self._gin = list(gin)
        else:
            self._rg = []
            self._bwd = None
        # the static outputs, without the captured autograd graph
        self._out = [o.detach() for o in outs]

    # ----------------------------------------------------------- replay
    def forward(self, inputs):
        """Replay the forward on ``inputs``; the outputs as copies."""
        with torch.no_grad():
            for s, x in zip(self._static_in, inputs):
                s.copy_(x)
        srcs = [(g, _rng.take_key(dev)) for dev, g in self._gens.items()]
        for g, src in srcs:
            g.set_state(src.get_state())
        self._fwd.replay()
        for g, src in srcs:
            src.set_state(g.get_state())
        return [o.clone() for o in self._out]

    def pool_bytes(self):
        """Bytes the caching allocator holds in this program's private
        memory pool (the segments of its graphs), from
        ``torch.cuda.memory_snapshot``; None where the snapshot does not
        name pools."""
        pool = tuple(self._fwd.pool())
        total, named = 0, False
        for seg in torch.cuda.memory_snapshot():
            pid = seg.get("segment_pool_id")
            if pid is None:
                continue
            named = True
            if tuple(pid) == pool:
                total += int(seg["total_size"])
        return total if named else None

    def held(self):
        """Whether the pool holds the activations of a recorded replay
        whose tape node lives and whose backward has not run."""
        return self._pending is not None and self._pending() is not None

    def backward(self, token, gouts):
        """Replay the backward of the recorded replay ``token`` for the
        output gradients ``gouts`` (None: zero); copies of the gradients
        of the inputs that require grad and of the parameters, None for
        the others.  A replay's backward runs once: it overwrites the
        activations it reads."""
        if self._pending is None or self._pending() is not token:
            raise MXNetError(
                f"{self.name}: the backward of a CUDA-graph replay runs "
                "once (retain_graph cannot keep its activations)")
        self._pending = None
        with torch.no_grad():
            for s, i in zip(self._gout, self._rg):
                if gouts[i] is None:
                    s.zero_()
                else:
                    s.copy_(gouts[i])
        self._bwd.replay()
        grads = iter(g.clone() if g is not None else None
                     for g in self._gin)
        return [next(grads) if s.requires_grad else None
                for s in self._static_in] + [next(grads)
                                             for _ in self._params]

    def __call__(self, inputs):
        """The outputs of one replay: a tape node when recording."""
        if self.record and self._bwd is not None:
            return list(_Replay.apply(self, *inputs, *self._params))
        return self.forward(inputs)


class _Token:
    """Marks one recorded replay; it lives as long as the replay's tape
    node."""

    __slots__ = ("__weakref__",)


class _Replay(torch.autograd.Function):
    """One replay of a recording entry: the forward graph, and the
    backward graph as its backward."""

    @staticmethod
    def forward(ctx, prog, *tensors):
        ctx.prog = prog
        ctx.token = _Token()
        prog._pending = weakref.ref(ctx.token)
        outs = prog.forward(tensors[:len(prog._static_in)])
        rg = set(prog._rg)
        ctx.mark_non_differentiable(*[o for i, o in enumerate(outs)
                                      if i not in rg])
        return tuple(outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gouts):
        return (None, *ctx.prog.backward(ctx.token, gouts))
