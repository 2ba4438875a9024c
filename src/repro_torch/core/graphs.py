"""Order-(H, K) weak memory on time-series graphs (port of
`repro.core.graphs`; paper §9, §11).

A time-series graph is ((X_t^v)_{v in V})_t.  An estimator has order-(H, K)
weak memory if its kernel at (t, v) reads only vertices at most K hops away
within +-H time steps, and the overlapping structure generalises: the
vertices split into parts, each part replicating its K-hop boundary (the
graph halo, paper Fig. 5).

A graph is a dense padded neighbour table ``nbrs (V, max_deg)`` with -1
padding: gathers instead of pointer chasing.  The graph and its partition
are host numpy; the map-reduce and the traffic simulation run where the
series lies (the card unless the caller asks for the CPU).

Includes the paper's running example, the order-(1, 1) arterial-traffic
Dynamic Bayesian Network (§11.1.1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .backend import resolve_device
from .mapreduce import tree_map

__all__ = ["Graph", "line_graph", "grid_graph", "k_hop_neighbors", "GraphPartition",
           "make_graph_partition", "graph_window_map_reduce", "traffic_dbn_step",
           "simulate_traffic_dbn"]


@dataclasses.dataclass(frozen=True)
class Graph:
    """Padded dense adjacency: nbrs[v] lists the neighbours of v, -1 = padding."""

    nbrs: np.ndarray  # (V, max_deg) int32

    @property
    def num_vertices(self) -> int:
        return self.nbrs.shape[0]


def line_graph(v: int) -> Graph:
    """A road corridor: v links in a line (the paper's arterial example);
    slot 0 is the upstream link, slot 1 the downstream one."""
    nbrs = np.full((v, 2), -1, dtype=np.int32)
    nbrs[1:, 0] = np.arange(v - 1)
    nbrs[:-1, 1] = np.arange(1, v)
    return Graph(nbrs)


def grid_graph(rows: int, cols: int) -> Graph:
    """4-connected grid (sensor lattice, paper Fig. 3): each vertex lists
    its neighbours up, down, left, right, those inside the grid first."""
    r, c = np.divmod(np.arange(rows * cols), cols)
    cand = np.stack([(r - 1) * cols + c, (r + 1) * cols + c, r * cols + c - 1,
                     r * cols + c + 1], axis=1)
    inside = np.stack([r > 0, r < rows - 1, c > 0, c < cols - 1], axis=1)
    cand = np.where(inside, cand, -1)
    order = np.argsort(~inside, axis=1, kind="stable")  # valid slots first, in order
    return Graph(np.take_along_axis(cand, order, axis=1).astype(np.int32))


def k_hop_neighbors(g: Graph, seeds: np.ndarray, k: int) -> np.ndarray:
    """Boolean (V,) mask of the vertices within k hops of any seed (BFS)."""
    mask = np.zeros(g.num_vertices, dtype=bool)
    mask[seeds] = True
    for _ in range(k):
        nb = g.nbrs[np.where(mask)[0]].reshape(-1)
        mask[nb[nb >= 0]] = True
    return mask


def _own_local(own: np.ndarray, padded: np.ndarray) -> np.ndarray:
    """(P, own_size) position of each owned vertex in its part's padded row."""
    out = np.empty(own.shape, dtype=np.int32)
    width = int(max(own.max(initial=-1), padded.max(initial=-1))) + 1
    for i in range(own.shape[0]):
        g2l = np.full(width, -1, dtype=np.int32)
        valid = padded[i] >= 0
        g2l[padded[i][valid]] = np.nonzero(valid)[0]
        out[i] = g2l[own[i]]
    return out


@dataclasses.dataclass(frozen=True)
class GraphPartition:
    """Overlapping vertex partition: part i owns ``own[i]`` and replicates
    its K-hop boundary; ``padded[i] = own + halo`` padded to a common length
    with -1 so the parts stack into one array.  ``own_local``, derived
    from the two, is each owned vertex's slot in ``padded``."""

    own: np.ndarray  # (P, own_size) int32
    padded: np.ndarray  # (P, padded_size) int32, -1 padding
    local_nbrs: np.ndarray  # (P, padded_size, max_deg): neighbour slots remapped
    #   to local padded positions, -1 where the neighbour is absent
    own_local: np.ndarray = dataclasses.field(init=False)  # (P, own_size) int32

    def __post_init__(self):
        object.__setattr__(self, "own_local", _own_local(self.own, self.padded))


def make_graph_partition(g: Graph, num_parts: int, k: int) -> GraphPartition:
    """Contiguous vertex partition with K-hop halos (paper Fig. 5).

    Assumes vertex ids are ordered so that contiguous ranges are meaningful
    (true for line and grid graphs; a general graph is first ordered by a
    bandwidth-minimising permutation, as in the banded §6 case).
    """
    v = g.num_vertices
    if v % num_parts != 0:
        raise ValueError(f"V={v} must divide into {num_parts} parts")
    own = np.arange(v, dtype=np.int32).reshape(num_parts, v // num_parts)
    sets = [np.where(k_hop_neighbors(g, own[i], k))[0].astype(np.int32)
            for i in range(num_parts)]
    width = max(len(s) for s in sets)
    padded = np.full((num_parts, width), -1, dtype=np.int32)
    local_nbrs = np.full((num_parts, width, g.nbrs.shape[1]), -1, dtype=np.int32)
    g2l = np.full(v, -1, dtype=np.int32)
    for i, s in enumerate(sets):
        padded[i, : len(s)] = s
        g2l[s] = np.arange(len(s), dtype=np.int32)
        nb = g.nbrs[s]
        local_nbrs[i, : len(s)] = np.where(nb >= 0, g2l[np.maximum(nb, 0)], -1)
        g2l[s] = -1
    return GraphPartition(own=own, padded=padded, local_nbrs=local_nbrs)


def graph_window_map_reduce(kernel: Callable, x: torch.Tensor, g: Graph,
                            part: GraphPartition):
    """sum_v kernel(x[v], x[neighbours(v)], mask) computed part by part.

    ``kernel`` maps (d,), (max_deg, d), (max_deg,) bool to a statistic (a
    tensor or a tuple / list / dict of tensors).  Each part evaluates only
    its own vertices and reads its halo locally: the padded rows (P, W, d)
    and the owned vertices' neighbour rows (P, own, max_deg, d) are two
    gathers, a neighbour slot absent from the part reads zeros with its
    mask False, and ``torch.func.vmap`` runs the kernel over parts and
    vertices.  The contributions are summed per part, then over the parts.
    """
    if x.ndim == 1:
        x = x[:, None]
    dev = x.device
    P, W = part.padded.shape
    padded = torch.from_numpy(part.padded).to(dev).long()
    rows = x.index_select(0, padded.clamp(0, g.num_vertices - 1).reshape(-1))
    padded_x = torch.where((padded >= 0)[..., None], rows.view(P, W, -1), 0.0)
    own_local = torch.from_numpy(part.own_local).to(dev).long()
    nbr_slots = torch.from_numpy(part.local_nbrs).to(dev).long().gather(
        1, own_local[..., None].expand(-1, -1, part.local_nbrs.shape[2]))  # (P, own, deg)
    nb_mask = nbr_slots >= 0
    base = (torch.arange(P, device=dev) * W)[:, None, None]
    flat = padded_x.reshape(P * W, -1)
    xc = flat.index_select(0, (own_local + base[..., 0]).reshape(-1)).view(
        own_local.shape + (flat.shape[1],))
    nb = flat.index_select(0, (nbr_slots.clamp(0, W - 1) + base).reshape(-1)).view(
        nbr_slots.shape + (flat.shape[1],))
    nb = torch.where(nb_mask[..., None], nb, 0.0)
    contribs = torch.func.vmap(torch.func.vmap(kernel))(xc, nb, nb_mask)
    partials = tree_map(lambda leaf: leaf.sum(1), contribs)
    return tree_map(lambda leaf: leaf.sum(0), partials)


def traffic_dbn_step(x: torch.Tensor, nbrs: torch.Tensor, inflow,
                     capacity: float = 1.0, send_rate: float = 0.3) -> torch.Tensor:
    """One step of the order-(1, 1) arterial-traffic DBN (paper §11.1.1).

    Vehicles leave each link at ``send_rate``, bounded by the downstream
    link's spare capacity, and arrive from upstream; ``inflow`` is the
    boundary demand.  ``nbrs`` (V, 2): upstream, downstream, -1 for none.
    """
    v = x.shape[0]
    up, down = nbrs[:, 0], nbrs[:, 1]
    has_down, has_up = down >= 0, up >= 0
    down_occ = torch.where(has_down, x[down.clamp(0, v - 1)], 0.0)
    spare = torch.clamp(capacity - down_occ, min=0.0)
    out = torch.minimum(send_rate * x, spare) * has_down
    inn = torch.where(has_up, out[up.clamp(0, v - 1)], 0.0)
    return torch.clamp(x - out + inn + inflow, 0.0, capacity)


def simulate_traffic_dbn(g: Graph, x0, steps: int, generator: Optional[torch.Generator] = None,
                         inflow_scale: float = 0.05, device="cuda") -> torch.Tensor:
    """(steps + 1, V) trajectory of the traffic DBN from ``x0``, with random
    boundary demand at the vertices without an upstream link.  The (steps,
    V) float32 uniforms are drawn in one call from ``generator`` (on
    ``device``) before the loop; the trajectory takes ``x0``'s dtype."""
    dev = resolve_device(device)
    x = torch.as_tensor(x0, device=dev)
    if not x.is_floating_point():
        x = x.float()
    nbrs = torch.from_numpy(g.nbrs).to(dev).long()
    u = torch.rand((steps, g.num_vertices), generator=generator, device=dev)
    boundary = nbrs[:, 0] < 0
    traj = x.new_empty((steps + 1, g.num_vertices))
    traj[0] = x
    for t in range(steps):
        inflow = inflow_scale * u[t] * boundary
        x = traffic_dbn_step(x, nbrs, inflow.to(x.dtype))
        traj[t + 1] = x
    return traj
