"""The port's roofline layer (`repro_torch.launch.roofline`) and its
counting trace (`repro_torch.launch.costing`) against the reference's
`repro.launch.roofline` and against closed forms.

``active_param_count`` and ``model_flops_estimate`` equal the reference's
exactly for every arch and shape of the matrix.  On a reduced dense model
(qwen3, 2 layers, d_model 64) the traced function FLOPs of a train cell
and of a prefill cell equal their closed forms exactly: the matrix
products (three times in a train step), attention at 2 (D + DV) a causal
pair of each head, the prefill's lm_head at the last position only.  The
counting mode's live bytes count a view once and hold autograd's saved
tensors; the roofline's terms, bottleneck and wire factors.
"""
import dataclasses

import pytest
import torch

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.registry import get_arch as ref_get_arch
from repro.launch import roofline as ref_roofline
from repro_torch.configs import SHAPES, ShapeConfig, get_arch
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels.swa_attention.ref import valid_pairs
from repro_torch.launch import roofline
from repro_torch.launch.costing import CountingMode, attention_pairs, trace_cell

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_count_and_model_flops_match_reference(arch):
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    assert roofline.active_param_count(cfg) == ref_roofline.active_param_count(ref_cfg)
    for shape, ref_shape in zip(SHAPES, REF_SHAPES):
        assert shape.name == ref_shape.name
        assert (roofline.model_flops_estimate(cfg, shape)
                == ref_roofline.model_flops_estimate(ref_cfg, ref_shape))


def test_roofline_fields_and_wire_factors():
    ref_fields = {f.name for f in dataclasses.fields(ref_roofline.Roofline)}
    assert ref_fields <= {f.name for f in dataclasses.fields(roofline.Roofline)}
    assert roofline._WIRE_FACTOR == ref_roofline._WIRE_FACTOR
    stats = roofline.collective_stats({"all-gather": 2, "all-reduce": 1},
                                      {"all-gather": 100.0, "all-reduce": 10.0})
    assert stats.wire_bytes == 120.0 and stats.total_payload == 110.0
    assert stats.counts["reduce-scatter"] == 0


def test_roofline_terms():
    cfg, shape = get_arch("qwen3"), SHAPES[0]
    r = roofline.compute_roofline({"bfloat16": 989e12, "float32": 67e12}, 3.35e12, cfg, shape,
                                  4, collectives=roofline.collective_stats(
                                      {"all-gather": 1}, {"all-gather": 45e9}),
                                  executed_flops=2 * 1056e12)
    assert r.t_compute == pytest.approx(2.0) and r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(0.1) and r.bottleneck == "compute"
    assert r.model_flops == roofline.model_flops_estimate(cfg, shape) / 4
    assert r.useful_flops_ratio == r.model_flops / (2 * 1056e12)


def _small_qwen3():
    return dataclasses.replace(get_arch("qwen3").reduced(), n_layers=2)


def _products(cfg) -> int:
    """Multiply-adds a token of one layer's projections and MLP."""
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return d * h * hd + 2 * d * kvh * hd + h * hd * d + 3 * d * cfg.d_ff


@pytest.mark.parametrize("b,s", [(2, 48), (3, 40)])
def test_counted_function_flops_closed_form(b, s):
    cfg = _small_qwen3()
    L, d, v, h, hd = cfg.n_layers, cfg.d_model, cfg.vocab, cfg.n_heads, cfg.resolved_head_dim
    attn = 2 * (hd + hd) * valid_pairs(s, s) * b * h
    pre = trace_cell(cfg, ShapeConfig("p", s, b, "prefill"), dtype=torch.float32)
    want = L * (2 * b * s * _products(cfg) + attn) + 2 * b * d * v
    assert pre.function_flops == {"float32": want}
    # kernel 8's work is its formula in both counts: nothing else runs
    assert pre.executed_flops == want
    tr = trace_cell(cfg, ShapeConfig("t", s, b, "train"), dtype=torch.float32)
    want = 3 * (L * (2 * b * s * _products(cfg) + attn) + 2 * b * s * d * v)
    assert tr.function_flops == {"float32": want}
    # executed: every layer's forward four times (the forward, remat's
    # recompute, the backward's two products) with the plain attention's
    # whole (S, S) squares (one chunk at S <= 512), less the recompute of
    # the layer's last product (w_down: the checkpoint stops recomputing
    # once every saved tensor the backward needs is back); lm_head three
    # times
    square = 2 * (hd + hd) * s * s * b * h
    assert tr.executed_flops == (4 * L * (2 * b * s * _products(cfg) + square)
                                 - L * 2 * b * s * cfg.d_ff * d + 3 * 2 * b * s * d * v)


def test_attention_pairs():
    for s, w in [(1, 1), (7, 3), (64, 64), (100, 16), (33, 200)]:
        assert attention_pairs(s, s, w) == valid_pairs(s, w)
        assert attention_pairs(s, s, None) == valid_pairs(s, s)
    assert attention_pairs(5, 9, None, causal=False) == 45
    # queries at positions 4..5 against 6 keys: 5 + 6
    assert attention_pairs(2, 6, None, q_pos0=4) == 11


def test_counting_mode_live_bytes():
    mode = CountingMode()
    with mode:
        a = torch.empty((1000,), device="meta")
        v = a.view(10, 100)
        assert mode.live == 4000  # a view shares its base's storage
        b = a * 2
        assert mode.live == 8000 and mode.peak == 8000
        del b
        assert mode.live == 4000
        w = torch.empty((100, 10), device="meta", requires_grad=True)
        y = (v @ w).sum()
        del v
        held = mode.live  # autograd holds v (a's storage) and w
        y.backward(torch.ones_like(y))
    assert held >= 4000 + 4000
    assert mode.executed_flops["float32"] == 2 * 2 * 10 * 100 * 10  # forward + grad of w
    assert mode.function_flops["float32"] == 2 * 10 * 100 * 10  # the forward only
    assert mode.peak >= 8000


def test_counting_mode_executed_bytes():
    mode = CountingMode()
    with mode:
        a = torch.empty((256,), device="meta")
        b = a + 1  # 1 KiB read, 1 KiB written
        c = a.view(16, 16)  # a view moves nothing
        c.add_(b.view(16, 16))  # reads b, writes c in place
    assert mode.executed_bytes == 2 * 1024 + 2 * 1024
