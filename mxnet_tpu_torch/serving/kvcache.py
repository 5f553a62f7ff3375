"""Paged KV-cache pool for generative decode serving (counterpart of
``mxnet_tpu/serving/kvcache.py``).

The pool owns a fixed set of physical KV pages sized to fit under a
device byte budget, and sequences hold ``ceil(tokens / page_tokens)``
pages reserved up front for their whole token budget (prompt +
max_new): admission is by token budget, and an admitted sequence can
never exhaust the pool mid-decode.

Physical page 0 is reserved as the null page: inactive decode slots
point their page-table rows at it and the decode step's unconditional
writes land there (masked attention never reads it).  Allocation never
hands out page 0.

Storage dtype is ``float32`` or ``int8`` — int8 pages carry one fp32
scale per (token, head) (quantization.kv).

Where the reference's jitted writes donate the page arrays and return
new ones (``.at[].set``), the port writes the pool tensors in place
with indexed assignment; the tensors never change identity.  Host-side
page bookkeeping is plain Python under the caller's lock.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from ..base import MXNetError
from ..quantization.kv import kv_page_bytes, kv_quantize

__all__ = ["PagedKVPool"]


class PagedKVPool:
    """Fixed pool of physical KV pages under a byte budget, on
    ``device`` (default ``cuda:0``; the server passes its own)."""

    def __init__(self, layers, heads, head_dim, page_tokens=None,
                 budget_bytes=None, dtype=None, device=None):
        from ..config import get_env
        from ..context import resolve_device

        self.layers = int(layers)
        self.heads = int(heads)
        self.head_dim = int(head_dim)
        self.device = resolve_device(device)
        self.page_tokens = int(page_tokens if page_tokens is not None
                               else get_env("MXNET_KV_PAGE_TOKENS"))
        budget = int(budget_bytes if budget_bytes is not None
                     else get_env("MXNET_KV_POOL_BUDGET"))
        dtype = str(dtype if dtype is not None
                    else get_env("MXNET_KV_DTYPE"))
        if dtype in ("fp32", "float32"):
            dtype = "float32"
        elif dtype != "int8":
            raise MXNetError(
                f"unsupported KV-cache dtype {dtype!r} "
                "(float32 or int8)")
        self.dtype = dtype
        self.budget_bytes = budget
        self.page_bytes = kv_page_bytes(self.layers, self.page_tokens,
                                        self.heads, self.head_dim,
                                        dtype)
        self.num_pages = budget // self.page_bytes
        if self.num_pages < 1:
            raise MXNetError(
                f"KV pool budget {budget} B fits no {dtype} page "
                f"({self.page_bytes} B each) — raise "
                "MXNET_KV_POOL_BUDGET or shrink MXNET_KV_PAGE_TOKENS")
        # +1: physical page 0 is the reserved null page (module doc)
        phys = self.num_pages + 1
        shape = (self.layers, phys, self.page_tokens, self.heads,
                 self.head_dim)
        store = torch.int8 if dtype == "int8" else torch.float32
        self.k_pages = torch.zeros(shape, dtype=store, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=store, device=self.device)
        if dtype == "int8":
            self.k_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=self.device)
            self.v_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=self.device)
        else:
            self.k_scale = None
            self.v_scale = None
        self._free = list(range(1, phys))
        self._seqs = {}  # seq id -> [physical page ids]

    # ------------------------------------------------------- accounting
    @property
    def pages_in_use(self):
        return sum(len(p) for p in self._seqs.values())

    @property
    def free_pages(self):
        return len(self._free)

    @property
    def capacity_tokens(self):
        return self.num_pages * self.page_tokens

    def pages_needed(self, tokens):
        return max(1, math.ceil(int(tokens) / self.page_tokens))

    def capacity_sequences(self, tokens_per_seq):
        """Concurrent sequences of the given token budget this pool
        admits."""
        return self.num_pages // self.pages_needed(tokens_per_seq)

    def can_admit(self, tokens):
        return self.pages_needed(tokens) <= len(self._free)

    # ------------------------------------------------------- allocation
    def alloc(self, seq_id, tokens):
        """Reserve pages for a sequence's whole token budget; returns
        the physical page list (logical order)."""
        if seq_id in self._seqs:
            raise MXNetError(f"sequence {seq_id!r} already holds pages")
        need = self.pages_needed(tokens)
        if need > len(self._free):
            raise MXNetError(
                f"pool exhausted: {need} pages needed, "
                f"{len(self._free)} free")
        pages = [self._free.pop() for _ in range(need)]
        self._seqs[seq_id] = pages
        return list(pages)

    def free(self, seq_id):
        """Return a sequence's pages to the free list (idempotent);
        returns the number reclaimed."""
        pages = self._seqs.pop(seq_id, None)
        if not pages:
            return 0
        self._free.extend(pages)
        return len(pages)

    def reset(self):
        """Reclaim every page; stale device data stays in place —
        masked attention never reads it."""
        n = self.pages_in_use
        for seq_id in list(self._seqs):
            self.free(seq_id)
        return n

    def page_table_row(self, seq_id, max_pages):
        """The sequence's page list as a fixed-width int row, tail
        padded with the null page."""
        pages = self._seqs.get(seq_id, [])
        if len(pages) > max_pages:
            raise MXNetError(
                f"sequence {seq_id!r} holds {len(pages)} pages, slot "
                f"rows are {max_pages} wide")
        row = onp.zeros(max_pages, onp.int64)
        row[:len(pages)] = pages
        return row

    # ----------------------------------------------------- device state
    def arrays(self):
        """(k_pages, v_pages, k_scale, v_scale); scales are None on an
        fp32 pool."""
        return self.k_pages, self.v_pages, self.k_scale, self.v_scale

    def write_prompt(self, seq_id, k, v):
        """Write a prefilled prompt's K/V into the sequence's pages.

        ``k``/``v``: (layers, tokens, heads, head_dim) float tensors —
        only the valid prompt tokens (bucket padding already sliced
        off).  The tail of the last page is written with zeros, as in
        the reference's page-granular writes."""
        pages = self._seqs.get(seq_id)
        if pages is None:
            raise MXNetError(f"sequence {seq_id!r} holds no pages")
        tokens = k.shape[1]
        t = self.page_tokens
        pad = (-tokens) % t
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        n_pages = k.shape[1] // t
        shape = (self.layers, n_pages, t, self.heads, self.head_dim)
        k = k.reshape(shape)
        v = v.reshape(shape)
        idx = torch.tensor(pages[:n_pages], dtype=torch.long,
                           device=self.device)
        if self.dtype == "int8":
            kq, ks = kv_quantize(k)
            vq, vs = kv_quantize(v)
            self.k_pages[:, idx] = kq
            self.v_pages[:, idx] = vq
            self.k_scale[:, idx] = ks
            self.v_scale[:, idx] = vs
        else:
            self.k_pages[:, idx] = k.to(self.k_pages.dtype)
            self.v_pages[:, idx] = v.to(self.v_pages.dtype)
