"""Architecture configuration (port of `repro.configs.base`).

One `ArchConfig` per architecture, with ``reduced()`` -- a tiny config of
the same family for CPU tests, and the shape suites of the reference's
dry-run matrix (`ShapeConfig`, `SHAPES`, `cell_is_runnable`).  A copy, not
an import: importing `repro.configs` runs `repro/__init__.py`, which
imports JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

__all__ = ["ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "ShapeConfig", "SHAPES",
           "SHAPES_BY_NAME", "cell_is_runnable"]

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]
AttnKind = Literal["gqa", "mla"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 1
    num_shared: int = 0  # shared (always-on) experts
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # "gather" (index-based, default) or "einsum" (GShard one-hot — kept as
    # the §Perf iteration-0 reference; costs O(T·E·C·d) extra matmul flops)
    dispatch: str = "gather"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 → direct q projection
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 256
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 → d_model // n_heads
    attn: AttnKind = "gqa"
    qk_norm: bool = False
    swa_window: Optional[int] = None  # sliding-window attention width
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every k ssm layers
    shared_attn_every: int = 0
    # encdec (whisper)
    enc_layers: int = 0
    # vlm (llava): number of image patch embeddings prefixed to the text
    n_patches: int = 0
    # xlstm: indices pattern — place an sLSTM block every k blocks (rest mLSTM)
    slstm_every: int = 0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # The reference's costing, remat and sequence-parallel switches: kept so
    # the fields match `repro.configs.base.ArchConfig`; the port's serving
    # path reads none of them.
    unroll_layers: bool = False
    remat_policy: str = "full"
    seq_parallel_residual: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_subquadratic(self) -> bool:
        """Attention cost linear in the sequence (SSM, hybrid or windowed)."""
        return self.family in ("ssm", "hybrid") or self.swa_window is not None

    @property
    def has_decode(self) -> bool:
        """Encoder-only archs have no decode step; all assigned archs here
        are decoder-bearing (whisper has a decoder)."""
        return True

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        r = dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4 if self.shared_attn_every else 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads // max(1, self.n_heads // 4))),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=512,
            swa_window=16 if self.swa_window else None,
            shared_attn_every=3 if self.shared_attn_every else 0,
            enc_layers=min(self.enc_layers, 2),
            n_patches=8 if self.n_patches else 0,
            slstm_every=self.slstm_every,
        )
        if self.moe:
            r = dataclasses.replace(
                r,
                moe=MoEConfig(
                    num_experts=4,
                    top_k=min(2, self.moe.top_k),
                    num_shared=min(1, self.moe.num_shared),
                    d_ff_expert=64,
                    # dropless for any routing (capacity = T·k): keeps the
                    # reduced-config smoke/consistency tests deterministic
                    capacity_factor=4.0,
                ),
            )
        if self.mla:
            r = dataclasses.replace(
                r,
                mla=MLAConfig(
                    kv_lora_rank=32, q_lora_rank=0, rope_head_dim=8,
                    nope_head_dim=16, v_head_dim=16,
                ),
            )
        if self.ssm:
            r = dataclasses.replace(
                r,
                ssm=SSMConfig(state_dim=16, head_dim=16, conv_width=4, chunk=32, expand=2),
            )
        return r


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


# The four shape suites of the dry-run matrix.
SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def cell_is_runnable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """The skip rules of the (arch x shape) matrix."""
    if shape.name == "long_500k" and not arch.is_subquadratic:
        return False, "pure full-attention arch — long_500k skipped (brief rule)"
    if shape.kind == "decode" and not arch.has_decode:
        return False, "encoder-only arch — no decode step"
    return True, ""
