"""Shared model primitives (port of `repro.models.layers`).

Weights keep the reference's (in, out) layout and are applied as ``x @ w``;
initialisers draw from an explicit ``torch.Generator``.  Norms, rotary
embedding and the SwiGLU activation compute in float32 and cast back, as
the reference does, so bf16 models round where the reference rounds.

The reference's ``scan_layers`` is a loop over an ``nn.ModuleList`` in
`transformer.py`; its cross-entropy functions arrive with training.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

__all__ = ["DTYPE", "dense_init", "embed_init", "rms_norm", "rope_frequencies", "apply_rope",
           "swiglu", "mlp_init", "RMSNorm", "MLP", "weight"]

DTYPE = torch.bfloat16  # activation / parameter dtype of the full-size configs


def weight(t: torch.Tensor) -> nn.Parameter:
    """A frozen parameter: serving only, no gradient."""
    return nn.Parameter(t, requires_grad=False)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype=DTYPE,
               device=None) -> torch.Tensor:
    scale = 1.0 / math.sqrt(in_dim)
    return (torch.randn((in_dim, out_dim), generator=gen, device=device) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype=DTYPE,
               device=None) -> torch.Tensor:
    return (torch.randn((vocab, dim), generator=gen, device=device) * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm, computed in float32 and cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) float32 inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, *,
               head_axis: Optional[bool] = None) -> torch.Tensor:
    """Rotary embedding over split halves (not interleaved pairs).

    x: (..., S, H, D) when ``head_axis`` (default for 4-D and more), else
    (..., S, D); positions: (S,) absolute positions.
    """
    d = x.shape[-1]
    if head_axis is None:
        head_axis = x.ndim >= 4
    inv = rope_frequencies(d, theta, x.device)
    ang = positions[:, None].float() * inv  # (S, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if head_axis:  # align with (..., S, H, D)
        cos, sin = cos[:, None, :], sin[:, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ w_down


class RMSNorm(nn.Module):
    def __init__(self, w: torch.Tensor, eps: float):
        super().__init__()
        self.weight = weight(w)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class MLP(nn.Module):
    """SwiGLU feed-forward with (in, out) weights."""

    def __init__(self, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = weight(w_gate), weight(w_up), weight(w_down)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x, self.w_gate, self.w_up, self.w_down)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=DTYPE, device=None) -> MLP:
    return MLP(dense_init(gen, d_model, d_ff, dtype, device),
               dense_init(gen, d_model, d_ff, dtype, device),
               dense_init(gen, d_ff, d_model, dtype, device))
