"""The index arithmetic of the redesigned kernel 8, rehearsed on the CPU.

The bf16 path of ``kernels/swa_attention/csrc/swa_attention.cu`` builds and
runs only on the card, so this file holds numpy models of its index
arithmetic, line for line, and checks them: the wgmma m64nN accumulator
layout, (thread, register) -> (row, column); the repacking of the S
accumulator into the bf16 A operand of P V; the 32-byte-swizzled D panels
that TMA writes for K and V and the consumer threads write for Q, against
the canonical K-major and MN-major layouts the wgmma descriptors name, for
every D the contract takes; each CTA's key tiles and each warpgroup's
masked / inner / skipped tiles, which must cover every valid (row, key) pair
exactly once and no invalid one; the order of the grid; the design
constants against the C #defines; and the whole walk, with its online
softmax, against the JAX reference.
"""
import importlib.util
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.swa_attention.ref import swa_attention_ref as jax_swa_ref
from repro_torch.kernels import _build

KEYS = _build.SWA_KEYS
WG_ROWS = _build.SWA_WG_ROWS
CONSUMERS = _build.SWA_CONSUMERS
ROWS = WG_ROWS * CONSUMERS
PANEL = _build.SWA_PANEL
D_CASES = [8, 40, 64, 72, 80, 128]
SOURCE = _build.KERNELS_DIR / "swa_attention" / "csrc" / "swa_attention.cu"


def _dk(d):
    return -(-d // PANEL) * PANEL


# ---------------------------------------------------------- fragments --

def acc_layout(n):
    """wgmma m64nNk16 f32 accumulator: (thread, register) -> (row, column),
    as the kernel reads it: register 4 j + e of thread t holds row
    16 warp + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2."""
    t = np.arange(128)[:, None]
    i = np.arange(n // 2)[None, :]
    warp, lane, j, e = t // 32, t % 32, i // 4, i % 4
    row = 16 * warp + lane // 4 + 8 * (e // 2)
    col = 8 * j + 2 * (lane % 4) + e % 2
    return np.broadcast_to(row, (128, n // 2)), np.broadcast_to(col, (128, n // 2))


def a_operand_layout():
    """wgmma m64k16 bf16 A operand from registers: (thread, register r,
    half h) -> (row, k): the mma.m16n8k16 A fragment of each warp's 16
    rows."""
    t = np.arange(128)[:, None, None]
    r = np.arange(4)[None, :, None]
    h = np.arange(2)[None, None, :]
    warp, lane = t // 32, t % 32
    row = 16 * warp + lane // 4 + 8 * (r % 2)
    k = 2 * (lane % 4) + 8 * (r // 2) + h
    shape = (128, 4, 2)
    return np.broadcast_to(row, shape), np.broadcast_to(k, shape)


@pytest.mark.parametrize("n", sorted({KEYS, 64, 128} | {_dk(d) for d in D_CASES}))
def test_accumulator_layout_is_a_bijection(n):
    row, col = acc_layout(n)
    flat = (row * n + col).ravel()
    assert np.array_equal(np.sort(flat), np.arange(64 * n))


@pytest.mark.parametrize("keys", [64, 128])
def test_p_repacking_is_the_a_operand_of_each_k_step(keys):
    """pa[kk][r] = pack(s[8 kk + 2 r], s[8 kk + 2 r + 1]): every (thread, r,
    half) of A step kk holds the S entry at (its row, 16 kk + its k)."""
    s_row, s_col = acc_layout(keys)
    a_row, a_k = a_operand_layout()
    for kk in range(keys // 16):
        src = 8 * kk + 2 * np.arange(4)[:, None] + np.arange(2)[None, :]  # (r, h)
        assert np.array_equal(s_row[:, src], a_row)
        assert np.array_equal(s_col[:, src], 16 * kk + a_k)


# --------------------------------------------------- shared-memory panels --

def swizzle32(addr):
    """The 32-byte swizzle on byte addresses (TMA SWIZZLE_32B and wgmma
    layout 3): bit 4 ^= bit 7."""
    return addr ^ (((addr >> 7) & 1) << 4)


def sw32_offset(row, col, rows):
    """swa_attention.cu sw32_offset: byte offset of bf16 element (row, col)
    in a stack of 16-column panels of ``rows`` rows."""
    half = ((col >> 3) & 1) ^ ((row >> 2) & 1)
    return (col >> 4) * rows * 32 + row * 32 + half * 16 + (col & 7) * 2


def tma_box_offset(row, col, rows):
    """Where TMA puts element (row, col) of the panel boxes (16 columns x
    ``rows`` rows, box p at p * rows * 32 bytes, each 256-byte aligned)."""
    return (col >> 4) * rows * 32 + swizzle32(row * 32 + (col & 15) * 2)


def kmajor_offset(row, k, start, sbo=256):
    """Canonical K-major 32-byte-swizzled wgmma operand: ((8, m), (8, 2)) :
    ((32 B, SBO), (2 B, 16 B)), swizzled on the absolute address."""
    return swizzle32(start + (row % 8) * 32 + (row // 8) * sbo + 2 * k)


def mnmajor_offset(n, key, start, lbo, sbo=256):
    """Canonical MN-major 32-byte-swizzled wgmma operand (transpose bit):
    ((8, 2, m), (8, k)) : ((2 B, 16 B, LBO), (32 B, SBO))."""
    return swizzle32(start + 2 * (n % 16) + lbo * (n // 16) + 32 * (key % 8) + sbo * (key // 8))


@pytest.mark.parametrize("d", D_CASES)
def test_panels_are_the_tma_boxes_and_the_wgmma_layouts(d):
    dk = _dk(d)
    # Q (ROWS rows), staged by the consumer threads: a bijection onto the
    # panel stack, equal to the TMA box layout
    r, c = np.meshgrid(np.arange(ROWS), np.arange(dk), indexing="ij")
    q_off = sw32_offset(r, c, ROWS)
    assert np.array_equal(np.sort(q_off.ravel()), 2 * np.arange(ROWS * dk))
    assert np.array_equal(q_off, tma_box_offset(r, c, ROWS))
    # Q K^T, k-step kk: A = a warpgroup's 64 rows of Q, B = the tile's keys
    for wg in range(CONSUMERS):
        for kk in range(dk // PANEL):
            rr, k = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
            start = kk * ROWS * 32 + wg * 64 * 32
            assert np.array_equal(kmajor_offset(rr, k, start),
                                  sw32_offset(wg * 64 + rr, 16 * kk + k, ROWS))
    kr, c = np.meshgrid(np.arange(KEYS), np.arange(dk), indexing="ij")
    kv_off = tma_box_offset(kr, c, KEYS)
    assert np.array_equal(np.sort(kv_off.ravel()), 2 * np.arange(KEYS * dk))
    for kk in range(dk // PANEL):
        key, k = np.meshgrid(np.arange(KEYS), np.arange(16), indexing="ij")
        assert np.array_equal(kmajor_offset(key, k, kk * KEYS * 32),
                              tma_box_offset(key, 16 * kk + k, KEYS))
    # P V, k-step kk over keys 16 kk .. 16 kk + 15: B = V, N = dk columns
    for kk in range(KEYS // 16):
        key, n = np.meshgrid(np.arange(16), np.arange(dk), indexing="ij")
        assert np.array_equal(mnmajor_offset(n, key, kk * 16 * 32, lbo=KEYS * 32),
                              tma_box_offset(16 * kk + key, n, KEYS))
    # wgmma descriptors hold start, LBO and SBO in 16-byte units, 14 bits
    assert KEYS * 32 % 16 == 0 and KEYS * 32 // 16 < 2**14


@pytest.mark.parametrize("d", D_CASES)
def test_columns_past_d_are_zero(d):
    """Q's staging loads 16-byte chunks with col < D and zeroes the rest;
    TMA fills the box past the map's D columns with zeros: so the products
    see zeros in the columns between D and DK."""
    rng = np.random.default_rng(d)
    dk = _dk(d)
    rows = rng.standard_normal((ROWS, d))
    smem = np.zeros(ROWS * dk)
    for r in range(ROWS):
        for col in range(0, dk, 8):  # the kernel's 16-byte chunks
            chunk = rows[r, col:col + 8] if col < d else np.zeros(8)
            for i in range(8):
                smem[sw32_offset(r, col + i, ROWS) // 2] = chunk[i]
    r, c = np.meshgrid(np.arange(ROWS), np.arange(dk), indexing="ij")
    got = smem[sw32_offset(r, c, ROWS) // 2]
    assert np.array_equal(got[:, :d], rows) and not got[:, d:].any()


# ----------------------------------------------------------- tile walk --

def cta_tiles(bx, s, g, w):
    """swa_tiles: the CTA's first row and key tiles; row blocks reversed."""
    rows_total = s * g
    n_blocks = -(-rows_total // ROWS)
    f0 = (n_blocks - 1 - bx) * ROWS
    f_last = min(f0 + ROWS, rows_total) - 1
    s_lo, s_hi = f0 // g, f_last // g
    kt0 = (max(0, s_lo - w + 1) // KEYS) * KEYS
    return f0, kt0, (s_hi - kt0) // KEYS + 1


def wg_tiles(f0, kt0, n_tiles, wg, s, g, w):
    """A consumer warpgroup's rows and its tiles [it_lo, it_hi]."""
    rows_total = s * g
    wf0 = f0 + wg * WG_ROWS
    live = wf0 < rows_total
    w_lo, w_hi = wf0 // g, min(wf0 + WG_ROWS - 1, rows_total - 1) // g
    it_lo = (max(0, w_lo - w + 1) - kt0) // KEYS if live else n_tiles
    it_hi = (w_hi - kt0) // KEYS if live else n_tiles - 1
    return wf0, w_lo, w_hi, it_lo, it_hi


def tile_mask(kt, wf0, w_lo, w_hi, g, w):
    """(64, KEYS) booleans: which (row, key) of the tile enter the softmax,
    computed per thread and register as the kernel does; None for an inner
    tile (no mask)."""
    if kt + KEYS - 1 <= w_lo and kt > w_hi - w:
        return None
    row, col = acc_layout(KEYS)
    t = np.arange(128)[:, None]
    i = np.arange(KEYS // 2)[None, :]
    lane, j, e = t % 32, i // 4, i % 4
    t2 = 2 * (lane % 4)
    pos = (wf0 + row) // g
    r = pos - kt - t2
    c = j * 8 + (e & 1)
    ok = (c <= r) & (c > r - w)
    out = np.zeros((64, KEYS), bool)
    out[row, col] = ok
    return out


def walk(s, g, w):
    """Yield (bx, wf0, it, kt, mask) for every tile a warpgroup multiplies."""
    n_blocks = -(-s * g // ROWS)
    for bx in range(n_blocks):
        f0, kt0, n_tiles = cta_tiles(bx, s, g, w)
        assert n_tiles >= 1 and kt0 % KEYS == 0 and kt0 <= f0 // g
        for wg in range(CONSUMERS):
            wf0, w_lo, w_hi, it_lo, it_hi = wg_tiles(f0, kt0, n_tiles, wg, s, g, w)
            assert 0 <= it_lo and it_hi < n_tiles
            for it in range(it_lo, it_hi + 1):
                kt = kt0 + it * KEYS
                yield bx, wf0, it, kt, tile_mask(kt, wf0, w_lo, w_hi, g, w)


@pytest.mark.parametrize("s", [1, 37, 300, 1000])
@pytest.mark.parametrize("w", ["1", "70", "4096", "s", "s+5"])
@pytest.mark.parametrize("g", [1, 2, 4, 7, 16])
def test_tiles_cover_every_valid_pair_once(s, w, g):
    """Every (row, key) with key in (pos - W, pos] enters exactly one
    warpgroup's softmax once, and no other pair does (keys past S, which TMA
    zero-fills, included)."""
    w = {"1": 1, "70": 70, "4096": 4096, "s": s, "s+5": s + 5}[w]
    rows_total = s * g
    span = -(-s // KEYS) * KEYS + KEYS
    count = np.zeros((rows_total + ROWS, span), np.int32)
    for _, wf0, _, kt, mask in walk(s, g, w):
        block = count[wf0:wf0 + WG_ROWS, kt:kt + KEYS]
        if mask is None:  # inner: every pair counts
            block += 1
        else:
            block += mask
    pos = np.arange(rows_total)[:, None] // g
    key = np.arange(span)[None, :]
    valid = (key <= pos) & (key > pos - w) & (key < s)
    assert np.array_equal(count[:rows_total], valid.astype(np.int32))


@pytest.mark.parametrize("s,w,g", [(8000, 4096, 4), (1000, 70, 7), (37, 4096, 16)])
def test_inner_tiles_need_no_mask_and_skips_are_empty(s, w, g):
    """An inner tile lies inside every window of its warpgroup's rows, and a
    tile a warpgroup skips meets none of them."""
    n_blocks = -(-s * g // ROWS)
    inner = masked = 0
    for bx in range(0, n_blocks, max(1, n_blocks // 40)):
        f0, kt0, n_tiles = cta_tiles(bx, s, g, w)
        for wg in range(CONSUMERS):
            wf0, w_lo, w_hi, it_lo, it_hi = wg_tiles(f0, kt0, n_tiles, wg, s, g, w)
            rows = np.arange(wf0, min(wf0 + WG_ROWS, s * g))
            if not rows.size:
                assert it_lo > it_hi
                continue
            pos = rows[:, None] // g
            for it in range(n_tiles):
                key = kt0 + it * KEYS + np.arange(KEYS)[None, :]
                valid = (key <= pos) & (key > pos - w)
                if not it_lo <= it <= it_hi:
                    assert not valid.any()
                elif tile_mask(kt0 + it * KEYS, wf0, w_lo, w_hi, g, w) is None:
                    assert valid.all()
                    inner += 1
                else:
                    masked += 1
    assert masked > 0 and (inner > 0 or min(w, s) < 4 * KEYS)


def test_grid_runs_full_windows_first_and_every_row_once():
    s, g, w = 8000, 4, 4096
    n_blocks = -(-s * g // ROWS)
    starts = [cta_tiles(bx, s, g, w)[0] for bx in range(n_blocks)]
    assert sorted(starts) == list(range(0, s * g, ROWS))
    # the CTAs with full windows first, then the others with less and less
    # work; among the full ones the tile count varies by one with the window
    # start's alignment to SWA_KEYS
    work = [cta_tiles(bx, s, g, w)[2] for bx in range(n_blocks)]
    full = [(n_blocks - 1 - bx) * ROWS // g >= w - 1 for bx in range(n_blocks)]
    assert full == sorted(full, reverse=True) and full[0] and not full[-1]
    tail = [n for n, f in zip(work, full) if not f]
    assert tail == sorted(tail, reverse=True)
    assert min(n for n, f in zip(work, full) if f) >= tail[0]
    assert max(work) - min(n for n, f in zip(work, full) if f) <= 1


def kernel_model(q, k, v, w, scale):
    """The bf16 path's walk in float64 for one batch row: q (S, H, D), k (S,
    KVH, D), v (S, KVH, DV) -> (S, H, DV), tile by tile in the kernel's
    order, with its online softmax in the log2 domain and its masking; P V
    of a tile lands before the next tile's rescale, as the overlapped loop
    orders it."""
    s, h, d = q.shape
    kvh, dv = k.shape[1], v.shape[2]
    g = h // kvh
    dk, dvp = _dk(d), _dk(dv)
    out = np.zeros((s, h, dv))
    scale2 = abs(scale) * math.log2(math.e)
    for head in range(kvh):
        kp = np.zeros((s + 2 * KEYS, dk))
        vp = np.zeros((s + 2 * KEYS, dvp))
        kp[:s, :d], vp[:s, :dv] = k[:, head], v[:, head]
        n_blocks = -(-s * g // ROWS)
        for bx in range(n_blocks):
            f0, kt0, n_tiles = cta_tiles(bx, s, g, w)
            for wg in range(CONSUMERS):
                wf0, w_lo, w_hi, it_lo, it_hi = wg_tiles(f0, kt0, n_tiles, wg, s, g, w)
                f = np.arange(wf0, wf0 + WG_ROWS)
                live = f < s * g
                qf = np.zeros((WG_ROWS, dk))
                qf[live, :d] = q[f[live] // g, head * g + f[live] % g]
                m = np.full(WG_ROWS, -1e30)
                l = np.zeros(WG_ROWS)
                o = np.zeros((WG_ROWS, dvp))
                for it in range(it_lo, it_hi + 1):
                    kt = kt0 + it * KEYS
                    raw = np.sign(scale) * qf @ kp[kt:kt + KEYS].T
                    mask = tile_mask(kt, wf0, w_lo, w_hi, g, w)
                    ok = np.ones_like(raw, bool) if mask is None else mask
                    mx = np.where(ok, raw, -np.finfo(np.float32).max).max(1)
                    mn = np.maximum(m, mx * scale2)
                    alpha = np.exp2(m - mn)
                    p = np.where(ok, np.exp2(raw * scale2 - mn[:, None]), 0.0)
                    l = alpha * l + p.sum(1)
                    o = alpha[:, None] * o + p @ vp[kt:kt + KEYS]
                    m = mn
                res = o / np.where(l > 0, l, 1.0)[:, None]
                out[f[live] // g, head * g + f[live] % g] = res[live, :dv]
    return out


@pytest.mark.parametrize("s,w,g,d,scale", [(150, 16, 7, 72, None), (37, 4096, 16, 40, None),
                                           (300, 130, 2, 80, -0.2), (1, 4, 4, 8, None)])
def test_kernel_walk_matches_the_jax_reference(s, w, g, d, scale):
    """The model of the whole walk against repro's swa_attention_ref (JAX,
    float32) on the same numpy inputs: within 1e-5 of the row's max|v|."""
    rng = np.random.default_rng(s + w + g + d)
    kvh = 2
    q = rng.standard_normal((s, g * kvh, d))
    k = rng.standard_normal((s, kvh, d))
    v = rng.standard_normal((s, kvh, d))
    sc = d ** -0.5 if scale is None else scale
    got = kernel_model(q, k, v, w, sc)
    kk = np.repeat(k, g, axis=1)
    vv = np.repeat(v, g, axis=1)
    want = np.asarray(jax_swa_ref(*(jnp.asarray(t.transpose(1, 0, 2), jnp.float32)
                                    for t in (q, kk, vv)), w, sc)).transpose(1, 0, 2)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(v).max()


# ----------------------------------------------------------- constants --

def _defines_of(src):
    return src, {name: int(val) for name, val in
                 re.findall(r"^#define (SWA_\w+) (\d+)\b", src, re.M)}


def _defines():
    return _defines_of(SOURCE.read_text())


def test_swa_constants_match_the_c_defines():
    """_build.SWA_CONSTANTS against swa_attention.cu's #defines, and the
    order rt_swa_constants writes them in (the built library is checked
    against them at load)."""
    src, defines = _defines()
    assert {name: defines[name] for name in _build.SWA_CONSTANTS} == {
        name: getattr(_build, name) for name in _build.SWA_CONSTANTS}
    assert (defines["SWA_MAX_D"], defines["SWA_MAX_DV"], defines["SWA_SMEM_MAX"]) == (
        192, 128, 232448)
    body = src[src.index("void rt_swa_constants"):]
    assert (re.findall(r"SWA_\w+", body[body.index("{"): body.index("};")])
            == list(_build.SWA_CONSTANTS.values()))


def _variants():
    """tools/kernel_variants/variants_bench.py, which patches copies of
    swa_attention.cu to other design points."""
    path = _build.REPO_ROOT / "tools" / "kernel_variants" / "variants_bench.py"
    spec = importlib.util.spec_from_file_location("variants_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("consumers", [1, 2, 3])
def test_register_and_shared_memory_budgets(consumers):
    """setmaxnreg only moves registers within the CTA's launch allocation
    (65,536 / threads, in steps of 8): the producer's and the consumers'
    counts fit it, the source's count is that of its own consumer
    warpgroups, and the largest D fits the card's 227 KB."""
    _, defines = _defines()
    producer = defines["SWA_PRODUCER_REGS"]
    threads = 128 * (consumers + 1)
    launch = min(255, 65536 // threads) // 8 * 8
    consumer = min(240, (launch * (consumers + 1) - producer) // consumers // 8 * 8)
    assert launch == {1: 255 // 8 * 8, 2: 168, 3: 128}[consumers]
    assert consumer == _variants().swa_consumer_regs(consumers)
    if consumers > 1:
        assert producer * 128 + consumer * 128 * consumers <= launch * threads
        assert consumer >= {2: 240, 3: 160}[consumers]
    if consumers == CONSUMERS:
        assert defines["SWA_CONSUMER_REGS"] == consumer
    dk = 128
    smem = (dk * 2 * WG_ROWS * CONSUMERS + 2 * _build.SWA_STAGES * dk * 2 * KEYS
            + 2 * _build.SWA_STAGES * 8 + 1024)
    assert smem <= 232448


def test_variant_patches_apply_to_the_source():
    """Every design point and ablation that variants_bench.py times is a
    patch of swa_attention.cu as it stands: each anchor is found once, the
    first point is the source itself, and the wgmma_ss overload it writes
    for another key tile is the source's own at SWA_KEYS."""
    vb = _variants()
    src = SOURCE.read_text()
    assert vb.SWA_POINTS[0] == (KEYS, _build.SWA_STAGES, CONSUMERS, 1, 1)
    assert vb._point_source(src, vb.SWA_POINTS[0]) == src
    assert set(vb.SWA_TURNS) <= set(vb.SWA_POINTS)
    for point in vb.SWA_POINTS[1:]:
        text = vb._point_source(src, point)
        _, defines = _defines_of(text)
        assert (defines["SWA_KEYS"], defines["SWA_STAGES"], defines["SWA_CONSUMERS"]) == point[:3]
        assert f"void wgmma_ss(float (&d)[{point[0] // 2}]" in text
        assert ("wgmma_wait<1>()" in text) == bool(point[3])
        assert ("bar_sync(1 + wg, 256)" in text) == bool(point[4])
    assert vb._wgmma_ss(KEYS) in src
    assert "#ifdef ABL_NO_TMA" in vb._patch(src, vb._ABLATION_PATCHES, "ablation")


# ------------------------------------------ q/k and v of different widths --

# (D, DV) pairs of the widened contract: multi-head latent attention's (192,
# 128), one the (192, 128) instantiation serves with zero columns, and pairs
# a square instantiation serves
DKV_CASES = [(192, 128), (184, 120), (136, 8), (24, 16), (128, 64), (64, 128), (80, 80)]


def instantiations():
    """The (DK, DV) pairs swa_attention.cu instantiates, from its dispatch."""
    src = SOURCE.read_text()
    body = src[src.index('extern "C" int rt_swa_attention'):src.index("rt_swa_params_size")]
    return [(int(a), int(b)) for a, b in re.findall(r"launch_bf16<(\d+), (\d+)>", body)]


def instantiation(d, dv):
    """rt_swa_attention's choice: (192, 128) past 128 columns of q/k, else
    the square one of the wider width, both rounded up to 16."""
    dk, dvp = _dk(d), _dk(dv)
    return (192, 128) if dk > 128 else (max(dk, dvp),) * 2


def smem_layout(dk, dv):
    """SwaSmem<DK, DV>: (stages, byte offsets of Q, K ring, V ring and the
    barriers, total bytes with the alignment slack)."""
    q_bytes = dk // PANEL * ROWS * 32
    k_bytes, v_bytes = dk // PANEL * KEYS * 32, dv // PANEL * KEYS * 32
    fit = (_build.SWA_SMEM_MAX - 1024 - q_bytes) // (k_bytes + v_bytes + 16)
    stages = min(fit, _build.SWA_STAGES)
    offsets = {"q": 0, "k": q_bytes, "v": q_bytes + stages * k_bytes,
               "bars": q_bytes + stages * (k_bytes + v_bytes)}
    return stages, offsets, offsets["bars"] + 2 * stages * 8 + 1024


def test_instantiations_cover_every_pair_with_the_smallest():
    """The source instantiates the eight square widths up to 128 and (192,
    128); each pair runs in the smallest instantiation whose q/k and v
    widths both cover it."""
    inst = instantiations()
    assert sorted(inst) == sorted([(n, n) for n in range(16, 129, 16)] + [(192, 128)])
    for d in range(8, _build.SWA_MAX_D + 1, 8):
        for dv in range(8, _build.SWA_MAX_DV + 1, 8):
            chosen = instantiation(d, dv)
            assert chosen in inst and chosen[0] >= d and chosen[1] >= dv
            covering = [p for p in inst if p[0] >= d and p[1] >= dv]
            assert sum(chosen) == min(sum(p) for p in covering)


@pytest.mark.parametrize("dk,dv", sorted({(n, n) for n in range(16, 129, 16)} | {(192, 128)}))
def test_shared_memory_layout_of_each_instantiation(dk, dv):
    """Every D <= 128 keeps SWA_STAGES stages, (192, 128) takes 3; the
    regions are disjoint, each tile starts on 256 bytes (the 32-byte
    swizzle's period) and the barriers on 8, all within a block's 227 KB."""
    stages, off, total = smem_layout(dk, dv)
    assert stages == (3 if dk > 128 else _build.SWA_STAGES)
    assert total <= _build.SWA_SMEM_MAX
    if dk == 192:
        assert total == 197680
    k_bytes, v_bytes = dk // PANEL * KEYS * 32, dv // PANEL * KEYS * 32
    starts = [off["k"] + i * k_bytes for i in range(stages)] + \
             [off["v"] + i * v_bytes for i in range(stages)]
    assert all(a % 256 == 0 for a in starts) and off["bars"] % 8 == 0
    assert off["k"] + stages * k_bytes == off["v"] and off["v"] + stages * v_bytes == off["bars"]
    # one stage more would not fit at (192, 128): 3 is the most
    if dk > 128:
        q_bytes = off["k"]
        assert q_bytes + (stages + 1) * (k_bytes + v_bytes + 16) + 1024 > _build.SWA_SMEM_MAX


@pytest.mark.parametrize("d,dv", DKV_CASES)
def test_wide_panels_are_the_tma_boxes_and_the_wgmma_layouts(d, dv):
    """In the instantiation a pair runs in: Q's and K's DK / 16 panels are
    the TMA boxes and the K-major descriptors of Q K^T, V's DV / 16 panels
    the MN-major descriptors of P V with N = DV; each box of K (V) lands in
    its own stage's K (V) region."""
    dk, dvp = instantiation(d, dv)
    stages, off, _ = smem_layout(dk, dvp)
    k_bytes, v_bytes = dk // PANEL * KEYS * 32, dvp // PANEL * KEYS * 32
    for kk in range(dk // PANEL):
        key, k = np.meshgrid(np.arange(KEYS), np.arange(16), indexing="ij")
        assert np.array_equal(kmajor_offset(key, k, kk * KEYS * 32),
                              tma_box_offset(key, 16 * kk + k, KEYS))
        rr, k = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
        for wg in range(CONSUMERS):
            assert np.array_equal(kmajor_offset(rr, k, kk * ROWS * 32 + wg * 64 * 32),
                                  sw32_offset(wg * 64 + rr, 16 * kk + k, ROWS))
    for kk in range(KEYS // 16):
        key, n = np.meshgrid(np.arange(16), np.arange(dvp), indexing="ij")
        assert np.array_equal(mnmajor_offset(n, key, kk * 16 * 32, lbo=KEYS * 32),
                              tma_box_offset(16 * kk + key, n, KEYS))
    # the producer's boxes: K panel pn at stage * K_BYTES + pn * KEYS * 32,
    # V panel pn at stage * V_BYTES + pn * KEYS * 32; expect_tx counts both
    for stage in range(stages):
        k_boxes = [off["k"] + stage * k_bytes + pn * KEYS * 32 for pn in range(dk // PANEL)]
        v_boxes = [off["v"] + stage * v_bytes + pn * KEYS * 32 for pn in range(dvp // PANEL)]
        assert (len(k_boxes) + len(v_boxes)) * KEYS * 32 == k_bytes + v_bytes
        assert k_boxes[-1] + KEYS * 32 <= off["v"] and v_boxes[-1] + KEYS * 32 <= off["bars"]
    # columns past the true widths: zero in Q and K past D (staging, TMA),
    # in V past DV (TMA); the output stores columns < DV only
    acc_row, acc_col = acc_layout(dvp)
    assert acc_col.max() == dvp - 1 and (acc_col < dv).sum() == 64 * dv


@pytest.mark.parametrize("s,w,g,d,dv", [(150, 40, 2, 192, 128), (70, 4096, 1, 184, 120),
                                        (100, 9, 4, 24, 16), (37, 37, 3, 64, 128)])
def test_walk_with_a_narrow_v_matches_the_jax_reference(s, w, g, d, dv):
    """The walk's model with v of DV columns against repro's dense
    swa_attention_ref (v's width passes through its einsum)."""
    rng = np.random.default_rng(s + d + dv)
    kvh = 2
    q = rng.standard_normal((s, g * kvh, d))
    k = rng.standard_normal((s, kvh, d))
    v = rng.standard_normal((s, kvh, dv))
    sc = d ** -0.5
    got = kernel_model(q, k, v, w, sc)
    assert got.shape == (s, g * kvh, dv)
    kk, vv = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)
    want = np.asarray(jax_swa_ref(*(jnp.asarray(t.transpose(1, 0, 2), jnp.float32)
                                    for t in (q, kk, vv)), w, sc)).transpose(1, 0, 2)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(v).max()
