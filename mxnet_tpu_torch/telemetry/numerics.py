"""Numerics monitor — Monitor 2.0 (``MXNET_NUMERICS``; counterpart of
``mxnet_tpu/telemetry/numerics.py``).

The NaN guard can say *that* a step went non-finite; this module says
*which tensor made it so*, with summary reductions cheap enough to run
every step:

``summary(x)`` -> a ``(6,)`` float32 tensor
    ``[l2_norm, min, max, nan_count, inf_count, zero_fraction]``
    (l2 over the finite elements so one Inf doesn't erase the norm;
    min/max are raw, so a poisoned tensor shows its NaN/Inf there).
    A plain torch reduction on the tensor's own device, as the
    reference's is a jnp one outside any Pallas kernel.

Wire points:

* ``make_train_step`` (armed at build time by ``MXNET_NUMERICS``):
  per-gradient summaries plus the loss ride in the returned optimizer
  state under the reserved ``_numerics`` key — no signature change, no
  host sync.  The telemetry wrapper reads them back only on sampled
  steps (``MXNET_NUMERICS_SAMPLE``, 0 = follow
  ``MXNET_TELEMETRY_SAMPLE``) and emits ``tensor_stats`` records.
* ``Module.fit``: the summaries of the named gradients run only on
  sampled steps and on every bad step.
* ``Monitor(stat_func="numerics")`` reports the same six numbers
  through the classic tic/toc protocol.

Unarmed contract: ``MXNET_NUMERICS`` unset means the built step is the
step without this module (no extra outputs, no reserved state entry)
and the per-step host cost is one captured boolean check.
"""
from __future__ import annotations

__all__ = ["STAT_FIELDS", "armed", "sample_period", "summary",
           "summarize_tree", "summary_template", "stats_row",
           "summarize_named", "emit", "nonfinite"]

#: order of the packed summary vector
STAT_FIELDS = ("l2", "min", "max", "nan", "inf", "zero_frac")


def armed():
    """``MXNET_NUMERICS`` from the registry (a build/arm-time check,
    never on the per-step hot path)."""
    from ..config import get_env

    try:
        return bool(get_env("MXNET_NUMERICS"))
    except Exception:
        return False


def sample_period():
    """Steps between ``tensor_stats`` emissions.  0 = follow
    ``MXNET_TELEMETRY_SAMPLE`` (one knob for the sync cadence)."""
    from ..config import get_env

    n = int(get_env("MXNET_NUMERICS_SAMPLE"))
    if n <= 0:
        n = int(get_env("MXNET_TELEMETRY_SAMPLE"))
    return max(1, n)


# ------------------------------------------------------------ on device
def summary(x):
    """The packed (6,) float32 summary of a tensor, on its device (no
    host sync)."""
    import torch

    xf = torch.as_tensor(getattr(x, "_data", x)).to(torch.float32)
    nan = torch.isnan(xf).sum().to(torch.float32)
    inf = torch.isinf(xf).sum().to(torch.float32)
    finite = torch.where(torch.isfinite(xf), xf, torch.zeros_like(xf))
    l2 = torch.sqrt(torch.sum(finite * finite))
    zero_frac = torch.mean((xf == 0.0).to(torch.float32))
    # raw min/max: a poisoned tensor shows its NaN/Inf here
    return torch.stack([l2, torch.amin(xf), torch.amax(xf), nan, inf,
                        zero_frac])


def summarize_tree(named):
    """``{name: tensor}`` -> ``{name: summary(tensor)}``."""
    return {str(k): summary(v) for k, v in named.items()}


def summary_template(named, device=None):
    """Zeros with the summaries' structure — the initial ``_numerics``
    entry of the optimizer state (a stable structure from step 0)."""
    import torch

    return {str(k): torch.zeros((len(STAT_FIELDS),), dtype=torch.float32,
                                device=device)
            for k in named}


# ------------------------------------------------------------ host side
def stats_row(vec):
    """One (6,) vector read to the host -> the labelled record row."""
    import numpy as onp

    if hasattr(vec, "detach"):
        vec = vec.detach().cpu().numpy()
    v = onp.asarray(vec, dtype="float64")
    return {"l2": float(v[0]), "min": float(v[1]), "max": float(v[2]),
            "nan": int(v[3]), "inf": int(v[4]),
            "zero_frac": float(v[5])}


def nonfinite(rows):
    """Whether any summarised tensor carried a NaN/Inf element."""
    return any(r["nan"] > 0 or r["inf"] > 0 for r in rows.values())


def summarize_named(named):
    """Summaries of host-visible named tensors (the Module path; NDArrays
    or tensors): call only on sampled/bad steps."""
    return summarize_tree(named)


def emit(rl, step, named_vecs, where="grad", epoch=None):
    """Read the summary vectors to host and write one ``tensor_stats``
    record (the single device sync the sampled step pays)."""
    import torch

    names = list(named_vecs)
    if names:
        # one stacked readback, not one sync per tensor
        host = torch.stack([named_vecs[k].detach().to(torch.float32)
                            for k in names]).cpu().numpy()
        rows = {k: stats_row(host[i]) for i, k in enumerate(names)}
    else:
        rows = {}
    bad = nonfinite(rows)
    rl.tensor_stats(step, rows, where=where, nonfinite=bad,
                    epoch=epoch)
    return rows, bad
