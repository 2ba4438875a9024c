"""Streaming sufficient statistics: the weak-memory monoid (port of
`repro.core.streaming`).

Every order-(h_left, h_right) weak-memory estimator is a sum of per-window
kernel contributions, so partial results over adjacent segments form a
monoid.  :class:`PartialState` carries the partial sum of every window fully
inside its segment plus the only context a later merge needs: the first and
last ``W-1`` samples, the length and the global start index.

``init`` / ``from_chunk`` / ``update`` / ``merge`` / ``finalize`` keep the
reference's semantics.  ``length`` and ``t0`` stay 0-d int32 tensors on the
engine's device and ``merge`` orders its operands with ``torch.where``, so
an update never synchronises with the host.  The reference's ``jit``,
``lax.scan`` and buffer donation become eager methods: ``consume`` is a
Python loop of updates.  Compensated mode threads a Neumaier error companion
(``stat_err``) through every fold; ``stat`` itself stays bit-identical to
plain mode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from .backend import BackendSpec, get_backend, resolve_device
from .integrity import tree_neumaier_add, tree_neumaier_merge
from .mapreduce import tree_leaves, tree_map, tree_sum, tree_zeros_like

__all__ = ["PartialState", "StreamingEngine", "resolved_stat", "state_from_numpy",
           "state_to_numpy"]

_FAR = 2**31 - 1
_FIELDS = ("stat", "sample_sum", "head", "tail", "length", "t0", "stat_err")


@dataclasses.dataclass
class PartialState:
    """Mergeable partial result of a weak-memory estimator over one segment.

    Attributes:
      stat: tensor or dict of tensors -- sum of the kernel contributions of
        every window fully inside the segment.
      sample_sum: (d,) plain sum of the covered samples.
      head: (W-1, d) first min(length, W-1) samples, left-aligned.
      tail: (W-1, d) last min(length, W-1) samples, right-aligned.
      length: () int32 samples covered.
      t0: () int32 global index of the first sample.
      stat_err: Neumaier companion mirroring ``stat`` (compensated engines
        only, else None).
    """

    stat: Any
    sample_sum: torch.Tensor
    head: torch.Tensor
    tail: torch.Tensor
    length: torch.Tensor
    t0: torch.Tensor
    stat_err: Any = None

    def flatten(self) -> list:
        """Every tensor of the state, in a fixed order."""
        return [leaf for f in _FIELDS for leaf in tree_leaves(getattr(self, f))]

    def unflatten(self, leaves) -> "PartialState":
        """A state of this one's structure holding ``leaves`` (as returned by
        :meth:`flatten`, possibly transformed)."""
        it = iter(leaves)
        return PartialState(**{f: tree_map(lambda _: next(it), getattr(self, f))
                               for f in _FIELDS})


def resolved_stat(state: PartialState) -> Any:
    """``state.stat`` with the Neumaier error companion folded in."""
    if state.stat_err is None:
        return state.stat
    return tree_map(lambda s, e: s + e, state.stat, state.stat_err)


def state_to_numpy(state: PartialState) -> dict:
    """The state's fields as numpy arrays (nested like ``stat``)."""
    return {f: tree_map(lambda t: t.detach().cpu().numpy(), getattr(state, f))
            for f in _FIELDS}


def state_from_numpy(d: dict, device="cuda") -> PartialState:
    """A PartialState from numpy fields -- e.g. the leaves of a state of the
    JAX reference, converted with ``np.asarray`` -- placed on ``device``."""
    dev = resolve_device(device)
    to = lambda a: torch.from_numpy(np.array(a)).to(dev)
    fields = {f: tree_map(to, d.get(f)) for f in _FIELDS}
    fields["length"] = fields["length"].to(torch.int32)
    fields["t0"] = fields["t0"].to(torch.int32)
    return PartialState(**fields)


class StreamingEngine:
    """init / update / merge / finalize for one weak-memory estimator.

    Args:
      d: series dimension.
      h_left, h_right: window half-widths (W = h_left + 1 + h_right).
      chunk_kernel: ``(y_padded (L+W-1, d), start_mask (L,)[, z0]) -> stat``,
        the masked sum of the window contributions over valid starts.
      stride: windows start only at global indices = 0 (mod stride).
      backend: compute backend recorded for the finalizers.
      kernel_takes_offset: the chunk kernel takes z0, the global index of
        its first row (a 0-d int32 device tensor).
      compensated: carry a Neumaier error companion (``stat_err``).
      stat_zeros: ``device -> stat`` of zeros with the kernel's structure.
        Without it the engine calls the chunk kernel once on a zero window.
      device: where the state lives ("cuda" by default).
    """

    def __init__(self, d: int, h_left: int = 0, h_right: int = 0,
                 chunk_kernel: Optional[Callable] = None, stride: int = 1,
                 backend: BackendSpec = None, kernel_takes_offset: bool = False,
                 compensated: bool = False, stat_zeros: Optional[Callable] = None,
                 device="cuda"):
        if chunk_kernel is None:
            raise ValueError("need a chunk_kernel")
        if h_left < 0 or h_right < 0:
            raise ValueError("halo widths must be non-negative")
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        self.device = resolve_device(device)
        self.d = d
        self.h_left = h_left
        self.h_right = h_right
        self.stride = stride
        self.backend = get_backend(backend, self.device)
        self.window = h_left + 1 + h_right
        self.carry = self.window - 1
        self.kernel_takes_offset = kernel_takes_offset
        self.compensated = compensated
        self.chunk_kernel = chunk_kernel
        if stat_zeros is None:
            probe = self._call_kernel(
                torch.zeros((self.window, d), device=self.device),
                torch.zeros((1,), dtype=torch.bool, device=self.device),
                self._scalar(0),
            )
            stat_zeros = lambda dev: tree_zeros_like(probe)
        self._stat_zeros = stat_zeros

    def _scalar(self, v) -> torch.Tensor:
        return torch.as_tensor(v, device=self.device).to(torch.int32)

    def _call_kernel(self, y, mask, z0):
        if self.kernel_takes_offset:
            return self.chunk_kernel(y, mask, z0)
        return self.chunk_kernel(y, mask)

    def _zeros_stat(self) -> Any:
        return self._stat_zeros(self.device)

    # -- monoid ------------------------------------------------------------
    def init(self, t0=0) -> PartialState:
        """The neutral element (an empty segment starting at ``t0``)."""
        z = lambda *s: torch.zeros(s, device=self.device)
        return PartialState(
            stat=self._zeros_stat(),
            sample_sum=z(self.d),
            head=z(self.carry, self.d),
            tail=z(self.carry, self.d),
            length=self._scalar(0),
            t0=self._scalar(t0),
            stat_err=self._zeros_stat() if self.compensated else None,
        )

    def from_chunk(self, chunk: torch.Tensor, t0=0) -> PartialState:
        """Lift one contiguous chunk into a PartialState (only windows fully
        inside the chunk enter ``stat``)."""
        if chunk.ndim == 1:
            chunk = chunk[:, None]
        c = chunk.shape[0]
        if c == 0:
            return self.init(t0)
        w, carry, dev = self.window, self.carry, self.device
        t0 = self._scalar(t0)
        y = torch.cat([chunk, chunk.new_zeros((carry, self.d))])
        starts = torch.arange(c, device=dev)
        mask = starts <= c - w
        if self.stride > 1:
            mask &= torch.remainder(t0 + starts, self.stride) == 0
        stat = self._call_kernel(y, mask, t0)

        rows = torch.arange(carry, device=dev)
        head = torch.where((rows < c)[:, None], chunk[rows.clamp(0, c - 1)], 0.0)
        tidx = c - carry + rows
        tail = torch.where((tidx >= 0)[:, None], chunk[tidx.clamp(0, c - 1)], 0.0)
        return PartialState(
            stat=stat,
            sample_sum=chunk.sum(0),
            head=head,
            tail=tail,
            length=self._scalar(c),
            t0=t0,
            stat_err=self._zeros_stat() if self.compensated else None,
        )

    def update(self, state: PartialState, chunk: torch.Tensor, t0=None) -> PartialState:
        """Absorb the next chunk: ``merge(state, from_chunk(chunk, end))``.
        ``t0`` seeds the global start when ``state`` is still empty."""
        start = state.t0 + state.length
        if t0 is not None:
            start = torch.where(state.length == 0, self._scalar(t0), start)
        return self.merge(state, self.from_chunk(chunk, start))

    def update_donated(self, state: PartialState, chunk: torch.Tensor) -> PartialState:
        """``update`` for a caller that owns ``state`` exclusively: the
        carried state may be updated in place, so no other alias of it may
        be read afterwards.  (This eager version returns a fresh state.)"""
        return self.update(state, chunk)

    def merge(self, a: PartialState, b: PartialState) -> PartialState:
        """The monoid sum of two states covering adjacent segments.

        Commutative: operands are ordered by ``t0`` on the device, empty
        states sort last.  The boundary-straddling windows are recovered
        from the carried halos with one chunk-kernel call, even when one
        operand is empty (its mask is then all false).
        """
        carry, w, dev = self.carry, self.window, self.device
        far = self._scalar(_FAR)
        key_a = torch.where(a.length > 0, a.t0, far)
        key_b = torch.where(b.length > 0, b.t0, far)
        swap = key_b < key_a
        la, lb = a.flatten(), b.flatten()
        first = a.unflatten([torch.where(swap, v, u) for u, v in zip(la, lb)])
        second = a.unflatten([torch.where(swap, u, v) for u, v in zip(la, lb)])

        if self.compensated:
            stat, err = tree_neumaier_merge(first.stat, first.stat_err,
                                            second.stat, second.stat_err)
        else:
            stat, err = tree_sum(first.stat, second.stat), None
        if carry > 0:
            k_first = torch.clamp(first.length, max=carry)
            k_second = torch.clamp(second.length, max=carry)
            # z = first's tail ++ second's head: every complete window in z
            # straddles the boundary, and every straddling window lies in z.
            z = torch.cat([first.tail, second.head])
            starts = torch.arange(carry, device=dev)
            mask = (starts >= carry - k_first) & (starts + w <= carry + k_second)
            # row s of z sits at global index first.t0 + first.length - carry + s
            z0 = first.t0 + first.length - carry
            if self.stride > 1:
                mask &= torch.remainder(z0 + starts, self.stride) == 0
            boundary = self._call_kernel(z, mask, z0)
            if self.compensated:
                stat, err = tree_neumaier_add(stat, err, boundary)
            else:
                stat = tree_sum(stat, boundary)

            rows = torch.arange(carry, device=dev)
            head = torch.where(
                (rows < first.length)[:, None],
                first.head,
                second.head[torch.clamp(rows - first.length, 0, carry - 1)],
            )
            tail = torch.where(
                (rows >= carry - second.length)[:, None],
                second.tail,
                first.tail[torch.clamp(rows + second.length, 0, carry - 1)],
            )
        else:
            head, tail = first.head, first.tail

        return PartialState(
            stat=stat,
            sample_sum=first.sample_sum + second.sample_sum,
            head=head,
            tail=tail,
            length=first.length + second.length,
            t0=torch.where(first.length > 0, first.t0, second.t0),
            stat_err=err,
        )

    def finalize(self, state: PartialState) -> Any:
        """Raw windowed statistic (the error companion folded in)."""
        return resolved_stat(state)

    def consume(self, state: PartialState, chunks) -> PartialState:
        """Fold a sequence (or (k, c, d) stack) of chunks, one update each."""
        for chunk in chunks:
            state = self.update(state, chunk)
        return state
