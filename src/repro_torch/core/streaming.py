"""Streaming sufficient statistics: the weak-memory monoid (port of
`repro.core.streaming`).

Every order-(h_left, h_right) weak-memory estimator is a sum of per-window
kernel contributions, so partial results over adjacent segments form a
monoid.  :class:`PartialState` carries the partial sum of every window fully
inside its segment plus the only context a later merge needs: the first and
last ``W-1`` samples, the length and the global start index.

``init`` / ``from_chunk`` / ``update`` / ``merge`` / ``finalize`` keep the
reference's semantics.  ``length`` and ``t0`` stay int32 tensors on the
engine's device and ``merge`` orders its operands with ``torch.where``, so
an update never synchronises with the host.  The reference's ``jit``,
``lax.scan`` and buffer donation become eager methods: ``consume`` is a
Python loop of updates.  Compensated mode threads a Neumaier error companion
(``stat_err``) through every fold; ``stat`` itself stays bit-identical to
plain mode.

Batches of independent series (the reference's ``vmap``: ``init_batch``,
``update_batch``, ``merge_batch``, ``consume_batch``) are states whose every
leaf has a leading series axis -- ``length`` and ``t0`` are (B,) -- and the
same methods serve them: an update of B series makes the same chunk-kernel
calls as an update of one (the chunk and the merge boundary), each over
all B series at once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from .backend import BackendSpec, get_backend, resolve_device
from .integrity import tree_neumaier_add, tree_neumaier_merge
from .mapreduce import _window_reduce, _windows, tree_leaves, tree_map, tree_sum, tree_zeros_like

__all__ = ["PartialState", "StreamingEngine", "resolved_stat", "state_from_numpy",
           "state_to_numpy"]

_FAR = 2**31 - 1
_FIELDS = ("stat", "sample_sum", "head", "tail", "length", "t0", "stat_err")


@dataclasses.dataclass
class PartialState:
    """Mergeable partial result of a weak-memory estimator over one segment.

    A batch of B states (see ``StreamingEngine.init_batch``) has a leading
    B axis on every leaf below.

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


def _bcast(cond: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A per-series ``cond`` (lead,) shaped to broadcast against ``leaf``
    (lead, ...)."""
    return cond.reshape(cond.shape + (1,) * (leaf.ndim - cond.ndim))


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
      kernel: per-window kernel ``(W, d) window -> stat``; optional when
        ``chunk_kernel`` is given.  The engine then builds its chunk kernel
        from an ``unfold`` of the padded chunk and a ``torch.func.vmap`` of
        ``kernel``, masked by the start mask.
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
                 kernel: Optional[Callable] = None,
                 chunk_kernel: Optional[Callable] = None, stride: int = 1,
                 backend: BackendSpec = None, kernel_takes_offset: bool = False,
                 compensated: bool = False, stat_zeros: Optional[Callable] = None,
                 device="cuda"):
        if kernel is None and chunk_kernel is None:
            raise ValueError("need a per-window kernel or a chunk_kernel")
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
        if chunk_kernel is None:
            if kernel_takes_offset:
                raise ValueError("kernel_takes_offset requires a chunk_kernel")
            chunk_kernel = self._vmapped_chunk_kernel(kernel)
        self.chunk_kernel = chunk_kernel
        if stat_zeros is None:
            probe = self._call_kernel(
                torch.zeros((self.window, d), device=self.device),
                torch.zeros((1,), dtype=torch.bool, device=self.device),
                self._scalar(0),
            )
            stat_zeros = lambda dev: tree_zeros_like(probe)
        self._stat_zeros = stat_zeros

    def _vmapped_chunk_kernel(self, kernel: Callable) -> Callable:
        """A chunk kernel from a per-window kernel: the windows at every
        start of y_padded (..., L + W - 1, d) as an ``unfold`` view, the
        kernel vmapped over them, the contributions of the starts where
        start_mask (..., L) is False zeroed, then summed over the starts."""
        w = self.window

        def ck(y_padded: torch.Tensor, start_mask: torch.Tensor):
            L = start_mask.shape[-1]
            wins = _windows(y_padded[..., : L + w - 1, :], 0, w - 1)
            return _window_reduce(kernel, wins, start_mask, start_mask.ndim - 1)

        return ck

    def _scalar(self, v) -> torch.Tensor:
        return torch.as_tensor(v, device=self.device).to(torch.int32)

    def _per_series(self, v, lead: tuple) -> torch.Tensor:
        """``v`` (a scalar or a (B,) array) as an int32 tensor of shape
        ``lead``, owning its storage."""
        t = self._scalar(v)
        return t.expand(lead).clone() if lead else t

    def _call_kernel(self, y, mask, z0):
        if self.kernel_takes_offset:
            return self.chunk_kernel(y, mask, z0)
        return self.chunk_kernel(y, mask)

    def _zeros_stat(self) -> Any:
        return self._stat_zeros(self.device)

    # -- monoid ------------------------------------------------------------
    def init_batch(self, batch: int, t0=0) -> PartialState:
        """Neutral states of ``batch`` independent series (a leading axis on
        every leaf); ``t0`` is a scalar or a (batch,) array of global
        starts."""
        one = self.init()
        tiled = one.unflatten([leaf.expand((batch,) + leaf.shape).clone()
                               for leaf in one.flatten()])
        tiled.t0 = self._per_series(t0, (batch,))
        return tiled

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
        inside the chunk enter ``stat``).  A (B, c, d) chunk lifts B series
        at once (``t0`` scalar or (B,)), with one chunk-kernel call."""
        if chunk.ndim == 1:
            chunk = chunk[:, None]
        lead, c = tuple(chunk.shape[:-2]), chunk.shape[-2]
        if c == 0:
            return self.init_batch(lead[0], t0) if lead else self.init(t0)
        w, carry, dev = self.window, self.carry, self.device
        t0 = self._per_series(t0, lead)
        y = torch.cat([chunk, chunk.new_zeros(lead + (carry, self.d))], -2)
        starts = torch.arange(c, device=dev)
        mask = starts <= c - w
        if self.stride > 1:
            mask = mask & (torch.remainder(t0[..., None] + starts, self.stride) == 0)
        mask = mask.expand(lead + (c,)).contiguous()
        stat = self._call_kernel(y, mask, t0)

        rows = torch.arange(carry, device=dev)
        head = torch.where((rows < c)[:, None], chunk[..., rows.clamp(0, c - 1), :], 0.0)
        tidx = c - carry + rows
        tail = torch.where((tidx >= 0)[:, None], chunk[..., tidx.clamp(0, c - 1), :], 0.0)
        if self.compensated:
            err = tree_map(lambda z: z.expand(lead + z.shape).clone(), self._zeros_stat())
        return PartialState(
            stat=stat,
            sample_sum=chunk.sum(-2),
            head=head,
            tail=tail,
            length=self._per_series(c, lead),
            t0=t0,
            stat_err=err if self.compensated else None,
        )

    def update(self, state: PartialState, chunk: torch.Tensor, t0=None) -> PartialState:
        """Absorb the next chunk: ``merge(state, from_chunk(chunk, end))``.
        ``t0`` seeds the global start when ``state`` is still empty.  A batch
        of states takes a (B, c, d) chunk and a (B,) ``t0``."""
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
        """The monoid sum of two states covering adjacent segments (or of two
        batches of states, series by series).

        Commutative: operands are ordered by ``t0`` on the device, empty
        states sort last.  Only the halos, lengths and starts are put in
        that order: the sums (and their Neumaier companions) are added as
        they come, since a float sum, and Neumaier's residue, are the same
        bits in either order.  The boundary-straddling windows are recovered
        from the carried halos with one chunk-kernel call, even when one
        operand is empty (its mask is then all false).
        """
        carry, w, dev = self.carry, self.window, self.device
        far = self._scalar(_FAR)
        key_a = torch.where(a.length > 0, a.t0, far)
        key_b = torch.where(b.length > 0, b.t0, far)
        swap = key_b < key_a

        def order(u, v):
            s = _bcast(swap, u)
            return torch.where(s, v, u), torch.where(s, u, v)

        first_len, second_len = order(a.length, b.length)
        first_t0, second_t0 = order(a.t0, b.t0)
        if self.compensated:
            stat, err = tree_neumaier_merge(a.stat, a.stat_err, b.stat, b.stat_err)
        else:
            stat, err = tree_sum(a.stat, b.stat), None
        if carry > 0:
            first_head, second_head = order(a.head, b.head)
            first_tail, second_tail = order(a.tail, b.tail)
            k_first = torch.clamp(first_len, max=carry)[..., None]
            k_second = torch.clamp(second_len, max=carry)[..., None]
            # z = first's tail ++ second's head: every complete window in z
            # straddles the boundary, and every straddling window lies in z.
            z = torch.cat([first_tail, second_head], -2)
            starts = torch.arange(carry, device=dev)
            mask = (starts >= carry - k_first) & (starts + w <= carry + k_second)
            # row s of z sits at global index first.t0 + first.length - carry + s
            z0 = first_t0 + first_len - carry
            if self.stride > 1:
                mask = mask & (torch.remainder(z0[..., None] + starts, self.stride) == 0)
            boundary = self._call_kernel(z, mask, z0)
            if self.compensated:
                stat, err = tree_neumaier_add(stat, err, boundary)
            else:
                stat = tree_sum(stat, boundary)

            rows = torch.arange(carry, device=dev)
            lf, ls = first_len[..., None], second_len[..., None]
            head = torch.where(
                (rows < lf)[..., None],
                first_head,
                torch.take_along_dim(second_head, torch.clamp(rows - lf, 0, carry - 1)[..., None],
                                     dim=-2),
            )
            tail = torch.where(
                (rows >= carry - ls)[..., None],
                second_tail,
                torch.take_along_dim(first_tail, torch.clamp(rows + ls, 0, carry - 1)[..., None],
                                     dim=-2),
            )
        else:
            head, tail = a.head, a.tail

        return PartialState(
            stat=stat,
            sample_sum=a.sample_sum + b.sample_sum,
            head=head,
            tail=tail,
            length=first_len + second_len,
            t0=torch.where(first_len > 0, first_t0, second_t0),
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

    # -- batches of series (the reference's vmapped entry points) ----------
    def update_batch(self, states: PartialState, chunks: torch.Tensor,
                     t0=None) -> PartialState:
        """B series absorb one (B, c, d) chunk stack: two chunk-kernel calls
        (the chunks and the merge boundary), whatever B."""
        return self.update(states, chunks, t0)

    def merge_batch(self, a: PartialState, b: PartialState) -> PartialState:
        """Series-by-series monoid sum of two batches of states."""
        return self.merge(a, b)

    def consume_batch(self, states: PartialState, chunks) -> PartialState:
        """Fold a (k, B, c, d) stack: k batched updates over all B series."""
        return self.consume(states, chunks)
