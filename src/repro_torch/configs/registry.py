"""The ten architectures of the reference's registry (a copy of
`repro.configs.registry`, data only).  ``get_arch(id)`` / ``list_archs()``."""
from __future__ import annotations

from typing import Dict

from .base import ArchConfig, MLAConfig, MoEConfig, SSMConfig

# — LM-family transformers (published numbers) —

LLAMA4_MAVERICK = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,  # expert FFN width
    vocab=202048,
    head_dim=128,
    moe=MoEConfig(num_experts=128, top_k=1, num_shared=1, d_ff_expert=8192),
    rope_theta=500000.0,
)

DEEPSEEK_V2 = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,  # expert FFN width
    vocab=102400,
    attn="mla",
    mla=MLAConfig(
        kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
        nope_head_dim=128, v_head_dim=128,
    ),
    moe=MoEConfig(num_experts=160, top_k=6, num_shared=2, d_ff_expert=1536),
    rope_theta=10000.0,
)

GLM4_9B = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
    rope_theta=10000.0,
)

QWEN3_0_6B = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
)

H2O_DANUBE = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    swa_window=4096,  # llama+mistral mix with sliding-window attention
    rope_theta=10000.0,
)

PHI3_MEDIUM = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    rope_theta=10000.0,
)

WHISPER_BASE = ArchConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,  # decoder layers
    enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
)

LLAVA_NEXT_34B = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    n_patches=2880,  # anyres tiling budget (frontend stubbed)
    rope_theta=5000000.0,
)

XLSTM_125M = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,  # block-internal projections (xLSTM style)
    vocab=50304,
    slstm_every=2,  # alternate sLSTM / mLSTM blocks
)

ZAMBA2_7B = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,  # shared attention block MLP width
    vocab=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, conv_width=4, chunk=256, expand=2),
    shared_attn_every=6,
)

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in (
        LLAMA4_MAVERICK,
        DEEPSEEK_V2,
        GLM4_9B,
        QWEN3_0_6B,
        H2O_DANUBE,
        PHI3_MEDIUM,
        WHISPER_BASE,
        LLAVA_NEXT_34B,
        XLSTM_125M,
        ZAMBA2_7B,
    )
}

# short aliases for --arch
ALIASES = {
    "llama4": "llama4-maverick-400b-a17b",
    "deepseek-v2": "deepseek-v2-236b",
    "glm4": "glm4-9b",
    "qwen3": "qwen3-0.6b",
    "danube": "h2o-danube-1.8b",
    "phi3": "phi3-medium-14b",
    "whisper": "whisper-base",
    "llava": "llava-next-34b",
    "xlstm": "xlstm-125m",
    "zamba2": "zamba2-7b",
}


def get_arch(name: str) -> ArchConfig:
    name = ALIASES.get(name, name)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)
