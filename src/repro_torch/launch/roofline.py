"""Roofline of an (arch x shape x mesh) cell on the H100 (port of
`repro.launch.roofline`).

Three terms per cell, all PER DEVICE:

  T_compute    = sum over dtypes of flops(dtype) / PEAK_FLOPS[dtype]
  T_memory     = hbm_bytes / HBM_BW
  T_collective = collective wire bytes / NVLINK_BW

The reference reads its flops and bytes from XLA's ``cost_analysis()`` of
the compiled program and parses collectives out of the HLO text.  The port
has no compiler to ask: `launch.costing` traces the cell's step on the
``meta`` device under a counting dispatch mode, and the collective term
comes from the port's own collective counter
(`parallel.sharding.collective_bytes`) or, for a cell that is not run,
from the payload the step would gather (`launch.costing`).

One deliberate difference from the reference: ``t_compute`` and
``t_memory`` are the FUNCTION's work, not what the eager program executed,
so that the bound stays the same whatever implements a layer.

  * FLOPs: the matrix products of the step.  Causal attention counts only
    its causal (or windowed) pairs; a train step counts its forward's
    products three times (forward, and the backward's two), and remat's
    recompute not at all.
  * Bytes: the compulsory traffic.  For a prefill or a decode step the
    parameters read once (of the embedding table, the gathered rows), the
    inputs and caches read and the outputs written (a decode step writes
    one position of a sequence-long cache, and the whole of a state); for
    a train step, the optimizer's pass (parameters read and written, the
    gradient read, float32 moments read and written).

What the eager program executed is reported beside the bound as
``executed_flops`` and ``executed_bytes`` (each aten op's inputs read and
outputs written), and ``useful_flops_ratio = model_flops /
executed_flops`` as in the reference.  Were the bound read from executed
FLOPs, every later kernel that removes redundant work (a flash backward in
place of the plain attention's whole squares) would lower its own bound.

The card's constants (NVIDIA's H100 SXM data sheet, dense rates without
sparsity, at the 700 W power limit; ``nvidia-smi --query-gpu=name,
power.limit --format=csv,noheader`` reads "NVIDIA H100 80GB HBM3, 700.00 W"
on the card they describe): 989 TFLOP/s bf16, 67 TFLOP/s float32 outside
the tensor cores (the port runs float32 products without TF32), 3.35 TB/s
HBM, 80 GB of HBM, and NVLink at 900 GB/s both directions together, 450
GB/s each way, the denominator of the collective term.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

from ..parallel.sharding import COLLECTIVES

__all__ = ["CARD", "CARD_POWER_LIMIT", "PEAK_BF16", "PEAK_FP32", "PEAK_FLOPS", "HBM_BW",
           "HBM_BYTES", "NVLINK_BW", "CollectiveStats", "collective_stats", "Roofline",
           "t_compute", "roofline_terms", "compute_roofline", "model_flops_estimate",
           "active_param_count"]

CARD = "NVIDIA H100 80GB HBM3"
CARD_POWER_LIMIT = "700.00 W"
PEAK_BF16 = 989e12  # FLOP/s, bf16 / fp16 on the tensor cores
PEAK_FP32 = 67e12  # FLOP/s, float32 outside the tensor cores
PEAK_FLOPS: Dict[str, float] = {"bfloat16": PEAK_BF16, "float16": PEAK_BF16,
                                "float32": PEAK_FP32}
HBM_BW = 3.35e12  # B/s
HBM_BYTES = 80e9  # B
NVLINK_BW = 450e9  # B/s each way

# wire multiplier per payload byte (ring algorithms, large-n asymptotics)
_WIRE_FACTOR = {
    "all-gather": 1.0,  # payload counted as the gathered (output) size
    "all-reduce": 2.0,  # reduce-scatter + all-gather
    "reduce-scatter": 1.0,  # payload = input size
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    payload_bytes: Dict[str, float]
    wire_bytes: float

    @property
    def total_payload(self) -> float:
        return sum(self.payload_bytes.values())


def collective_stats(counts: Mapping[str, float],
                     payload_bytes: Mapping[str, float]) -> CollectiveStats:
    """Counts and payload bytes by kind (any kind missing is 0) -> the
    stats with the reference's wire factors applied."""
    c = {k: counts.get(k, 0) for k in COLLECTIVES}
    p = {k: float(payload_bytes.get(k, 0.0)) for k in COLLECTIVES}
    return CollectiveStats(c, p, sum(p[k] * _WIRE_FACTOR[k] for k in COLLECTIVES))


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    wire_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_flops_ratio: float
    collective_counts: Dict[str, int]
    memory_per_device: Dict[str, float]
    flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)
    executed_flops: float = 0.0
    executed_bytes: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def t_compute(flops_by_dtype: Mapping[str, float]) -> float:
    """Seconds at the card's peak for each dtype's products (a dtype
    without a tensor-core rate at the float32 rate)."""
    return sum(f / PEAK_FLOPS.get(dt, PEAK_FP32) for dt, f in flops_by_dtype.items())


def roofline_terms(flops_by_dtype: Mapping[str, float], hbm_bytes: float,
                   wire_bytes: float) -> Dict[str, float]:
    """{"compute", "memory", "collective"} seconds."""
    return {"compute": t_compute(flops_by_dtype), "memory": hbm_bytes / HBM_BW,
            "collective": wire_bytes / NVLINK_BW}


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·D tokens (train) or 2·N_active·D (fwd-only)."""
    n_active = active_param_count(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def active_param_count(cfg) -> float:
    """Active (per-token) parameter count — MoE counts top_k+shared experts."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    hd = cfg.resolved_head_dim
    if cfg.attn == "mla":
        m = cfg.mla
        qd = cfg.n_heads * (m.nope_head_dim + m.rope_head_dim)
        attn = d * (m.q_lora_rank or 0) + (m.q_lora_rank or d) * qd
        if not m.q_lora_rank:
            attn = d * qd
        attn += d * m.kv_lora_rank + m.kv_lora_rank * cfg.n_heads * (
            m.nope_head_dim + m.v_head_dim
        )
        attn += d * m.rope_head_dim + cfg.n_heads * m.v_head_dim * d
    else:
        attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
    if cfg.moe is not None:
        ffn = 3 * d * cfg.moe.d_ff_expert * (cfg.moe.top_k + cfg.moe.num_shared)
    elif cfg.d_ff:
        ffn = 3 * d * cfg.d_ff
    else:
        ffn = 0
    if cfg.family == "ssm":
        d_in = 2 * d
        mix = d * 2 * d_in + d_in * 3 * d_in + d_in * d  # mLSTM-ish per block
        attn, ffn = 0, mix
    if cfg.family == "hybrid":
        s = cfg.ssm
        d_in = s.expand * d
        mamba = d * (2 * d_in + 2 * s.state_dim + d_in // s.head_dim) + d_in * d
        shared = (attn + 3 * d * cfg.d_ff) / max(cfg.shared_attn_every, 1)
        attn, ffn = shared, mamba
    enc = cfg.enc_layers * (attn + ffn) if cfg.family == "encdec" else 0
    return L * (attn + ffn) + enc + 2 * V * d


def compute_roofline(flops_by_dtype: Mapping[str, float], hbm_bytes: float, cfg, shape,
                     mesh_devices: int, *, collectives: Optional[CollectiveStats] = None,
                     executed_flops: float = 0.0, executed_bytes: float = 0.0,
                     memory_per_device: Optional[Dict[str, float]] = None) -> Roofline:
    """The cell's roofline from its per-device function work (FLOPs by
    dtype, compulsory bytes), its collectives and its executed counts."""
    coll = collectives or collective_stats({}, {})
    terms = roofline_terms(flops_by_dtype, hbm_bytes, coll.wire_bytes)
    flops = float(sum(flops_by_dtype.values()))
    mf = model_flops_estimate(cfg, shape) / mesh_devices  # per-device share
    return Roofline(
        flops=flops,
        hbm_bytes=float(hbm_bytes),
        wire_bytes=coll.wire_bytes,
        t_compute=terms["compute"],
        t_memory=terms["memory"],
        t_collective=terms["collective"],
        bottleneck=max(terms, key=terms.get),
        model_flops=mf,
        useful_flops_ratio=(mf / executed_flops) if executed_flops else 0.0,
        collective_counts=coll.counts,
        memory_per_device=dict(memory_per_device or {}),
        flops_by_dtype={k: float(v) for k, v in flops_by_dtype.items()},
        executed_flops=float(executed_flops),
        executed_bytes=float(executed_bytes),
    )
