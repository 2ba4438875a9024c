"""The audio and vision frontends as stubs (port of `repro.models.vlm_stub`).

The encoder-decoder (whisper-base) and the VLM (llava-next-34b) serve the
transformer backbone only; each frontend is replaced by precomputed
embeddings of its output contract:

  llava-next-34b : the anyres vision tower and projector -> patch
    embeddings (B, n_patches, d_model), :func:`fake_patch_embeds`.
  whisper-base   : log-mel and two stride-2 convolutions -> frame
    embeddings (B, S, d_model), :func:`fake_frame_embeds`.

Both draw unit normals in float32 from an explicit ``torch.Generator`` (the
reference's key) on ``device``, the card unless the caller asks for the
CPU, and cast them to ``dtype``.
"""
from __future__ import annotations

import torch

from ..core.backend import resolve_device
from .layers import DTYPE

__all__ = ["fake_patch_embeds", "fake_frame_embeds"]


def _unit_normal(generator: torch.Generator, shape, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=resolve_device(device)).to(dtype)


def fake_patch_embeds(generator: torch.Generator, batch: int, n_patches: int, d_model: int,
                      dtype=DTYPE, device="cuda") -> torch.Tensor:
    """Stand-in for the anyres vision tower's output (unit-scale embeddings)."""
    return _unit_normal(generator, (batch, n_patches, d_model), dtype, device)


def fake_frame_embeds(generator: torch.Generator, batch: int, n_frames: int, d_model: int,
                      dtype=DTYPE, device="cuda") -> torch.Tensor:
    """Stand-in for the whisper convolution frontend's output."""
    return _unit_normal(generator, (batch, n_frames, d_model), dtype, device)
