"""Batched serving engine: prefill + decode against static-capacity caches
(port of `repro.serving.engine`).

Request batches come as one (batch, prompt_len) grid; prefill fills the
layer caches, which grow to capacity ``max_len`` (prompt + generation
budget), then decode runs one step per new token.  Greedy or temperature
sampling.  The capacity-C cache convention matches `models`: ``pos`` is the
write index, and entries whose stored pos is above the current pos (or
below 0) are masked.

The engine runs on the card unless the caller passes ``device="cpu"``, and
its params must live there.  On the card, prefill's attention launches the
sliding-window attention kernel once per layer, and decode launches none.
PyTorch runs eagerly, so nothing is compiled ahead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.backend import resolve_device
from ..models import cache_spec, decode_step, prefill

__all__ = ["ServeEngine", "GenerationResult"]


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray  # (B, max_new)
    prompt_len: int
    logits: Optional[torch.Tensor] = None  # (B, max_new, V) float32, with keep_logits


class ServeEngine:
    def __init__(self, cfg, params, *, max_len: int, dtype=torch.float32, quantize: bool = False,
                 device="cuda"):
        """``dtype`` is the cache's, float32 by default as in the reference:
        pass the model's dtype for bf16 weights."""
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"the params lie on {params.embed.device}, the engine runs on "
                             f"{self.device}")
        if quantize:
            raise NotImplementedError("int8 weights wait for the port of serving/quant.py "
                                      "(ROADMAP Queue A item 11)")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.dtype = dtype

    def _grow_cache(self, cache: Dict[str, torch.Tensor], batch: int) -> Dict[str, torch.Tensor]:
        """Fit the prefill cache into capacity-max_len buffers of the
        engine's dtype (positions stay int32): pad ``pos`` with -1 and K/V
        with 0.  A cache longer than max_len (a ring cache of the window's
        length with max_len below the window) raises, as the reference's
        negative pad does."""
        spec = cache_spec(self.cfg, batch, self.max_len, dtype=self.dtype)
        out = {}
        for name, a in cache.items():
            shape, dtype = spec[name]
            if any(n > m for n, m in zip(a.shape, shape)):
                raise ValueError(f"cache {name} {tuple(a.shape)} does not fit capacity "
                                 f"{tuple(shape)} (max_len {self.max_len})")
            if tuple(a.shape) == tuple(shape):
                out[name] = a.to(dtype)
                continue
            fill = -1 if not a.dtype.is_floating_point else 0
            grown = torch.full(shape, fill, dtype=dtype, device=a.device)
            grown[tuple(slice(0, n) for n in a.shape)] = a
            out[name] = grown
        return out

    def generate(self, prompts, max_new: int, *, extra: Optional[Dict[str, Any]] = None,
                 temperature: float = 0.0, generator: Optional[torch.Generator] = None,
                 keep_logits: bool = False) -> GenerationResult:
        """Generate ``max_new`` tokens for every row of ``prompts`` (B,
        S_prompt) int.  Sampling is greedy unless ``temperature > 0`` and a
        ``generator`` (on the params' device) is given.  ``keep_logits``
        also returns every step's logits."""
        prompts = torch.as_tensor(prompts, device=self.params.embed.device).long()
        b, s_prompt = prompts.shape
        if s_prompt + max_new > self.max_len:
            raise ValueError(
                f"prompt {s_prompt} + max_new {max_new} exceeds max_len {self.max_len}")
        batch = {"tokens": prompts, **(extra or {})}
        logits, cache = prefill(self.params, batch, self.cfg)
        cache = self._grow_cache(cache, b)

        pos0 = s_prompt
        if self.cfg.family == "vlm":
            pos0 = s_prompt + self.cfg.n_patches

        out, kept = [], []
        tok = self._sample(logits, temperature, generator)
        out.append(tok)
        kept.append(logits.float() if keep_logits else None)
        for i in range(1, max_new):
            logits, cache = decode_step(self.params, cache,
                                        {"tokens": tok, "pos": pos0 + i - 1}, self.cfg)
            tok = self._sample(logits, temperature, generator)
            out.append(tok)
            kept.append(logits.float() if keep_logits else None)
        return GenerationResult(tokens=torch.stack(out, 1).cpu().numpy(), prompt_len=s_prompt,
                                logits=torch.stack(kept, 1) if keep_logits else None)

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if temperature <= 0.0 or generator is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
