"""Numpy model of kernel 3's batched path (H = 0, d <= 32), walked on the CPU.

``lag_moments_batched_kernel`` (``window_stats/csrc/window_stats.cu``) runs
only on the card.  This file walks its grid, as ``ops.batched_shape`` and
``ops.prepare_fused_lag_moments`` fill it, line for line in numpy: each CTA's
``tenants`` consecutive tenants, whole; each tenant's rows copied once into
the CTA's slot of rows of TW floats (16-byte pieces when d % 4 == 0, else 4-byte ones;
the channels past d zero); its start mask read through registers, E <= 4
bytes a thread (x + 256 j), and counted into the prefix count (a ballot a
warp and round, then the warp totals), the window counts read off it once; each thread's 4 x 4
upper block of S(0) over its row lane's valid starts, ascending; each
thread's channel of the moment sums over its row lane; the row lanes summed
in order; every upper entry stored to (i, j) and (j, i) of S(0).  The
walk checks that every staged element, mask byte, (valid start,
block) product and (row, channel) moment term is taken once, and that every
output is written exactly once; that a tenant's sums do not depend on the
CTA that holds it (tenants per CTA 1, 2, 4 give bitwise the same); and holds
the sums against the plain version (``fused_lag_moments_ref``) and the
reference's ``repro.kernels.window_stats.ref.fused_lag_moments_ref``, in
float32: S(0) within 1e-5 of its tenant's max|S(0)|, each moment sum within
1e-5 of the same sum taken over |y| (a first-moment sum cancels;
chip_smoke.py's scale).  Also: which of the three launches
:func:`ops.lag_moments_path` picks, and the mirrored constants and
parameter struct.
"""
import functools
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.window_stats import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels.window_stats import ops as ws, ref as wsr

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

THREADS, BLK = _build.THREADS, _build.LM_BATCH_BLK
F32 = np.float32
TOL = 1e-5
SMEM_LIMIT = 232448  # the H100's most dynamic shared memory a CTA
_CU = (_build.KERNELS_DIR / "window_stats" / "csrc" / "window_stats.cu").read_text()


def upper_pair(idx, T):
    """upper_pair: (a, b), a <= b, of entry idx of a T x T upper triangle."""
    a = 0
    while idx >= T - a:
        idx -= T - a
        a += 1
    return a, a + idx


def round4(x):
    return (x + 3) & ~3


def smem_floats(p, tw):
    """lb_smem_floats: the staged tenant, S(0)'s row lanes, the moment row
    lanes, the window counts, the prefix count, the warp counts of four
    rounds, the mask bytes."""
    side = tw // BLK
    blocks = side * (side + 1) // 2
    return (p.rows * tw + p.lanes * blocks * 16 + THREADS * 2 * p.K + round4(p.K * p.rows)
            + round4(p.n + 1) + 4 * THREADS // 32 + round4((p.n + 3) // 4))


def walk(p, y, mask):
    """Every CTA of the batched launch in numpy; returns (lag (B, 1, d, d),
    mom (B, K, 2, d), hits) with ``hits`` counting each write and read the
    kernel makes of each element.  (The kernel builds a tenant's prefix and
    window counts during the phases of the tenant before it; the walk, which
    has no phases, builds them in place.)"""
    B, n, d, rows, K = p.batch, p.n, p.d, p.rows, p.K
    windows = list(p.windows)[:K]
    tw = ws.lag_tile(d)
    side = tw // BLK
    NB = side * (side + 1) // 2
    ML = THREADS // tw
    lanes = p.lanes
    assert lanes * NB <= THREADS and rows * tw <= _build.LM_BATCH_SLOT
    E = -(-n // THREADS)
    assert E <= 4
    y = y.numpy().reshape(-1)  # flat, as the kernel indexes it
    mask = mask.numpy().reshape(-1)
    lag = np.zeros(B * d * d, F32)
    mom = np.zeros(B * 2 * K * d, F32)
    hits = {"lag": np.zeros(B * d * d, int), "mom": np.zeros(B * 2 * K * d, int),
            "copy": np.zeros(B * rows * d, int), "mask": np.zeros(B * n, int)}
    blocks = [upper_pair(b, side) for b in range(NB)]
    ctas = -(-B // p.tenants)
    for cta in range(ctas):
        tn0 = cta * p.tenants
        for tn in range(tn0, min(tn0 + p.tenants, B)):
            # the copy: pieces e of the tenant's contiguous rows into rows of tw
            ys = np.zeros((rows, tw), F32)
            src = tn * rows * d
            if p.vec:
                per_row = d // 4
                for e in range(rows * per_row):
                    r, c4 = divmod(e, per_row)
                    idx = src + 4 * e
                    assert idx + 4 <= B * rows * d
                    ys[r, 4 * c4: 4 * c4 + 4] = y[idx: idx + 4]
                    hits["copy"][idx: idx + 4] += 1
            else:
                for e in range(rows * d):
                    r, c = divmod(e, d)
                    ys[r, c] = y[src + e]
                    hits["copy"][src + e] += 1
            # the mask through registers: thread x holds bytes x + THREADS j
            mb = np.zeros((THREADS, 4), int)
            for x in range(THREADS):
                for j in range(4):
                    idx = x + THREADS * j
                    if j < E and idx < n:
                        mb[x, j] = mask[tn * n + idx]
                        hits["mask"][tn * n + idx] += 1
            # each round's ballot a warp: its valid starts, and those below each thread
            warps = THREADS // 32
            bits = (mb != 0).reshape(warps, 32, 4)
            wsum = bits.sum(1).T.reshape(-1)  # [round][warp]
            below = np.cumsum(bits, 1) - bits  # exclusive, within the warp
            pre = np.zeros(round4(n + 1), int)
            valid = np.zeros(n, int)
            for x in range(THREADS):
                warp, wl = divmod(x, 32)
                run = wsum[:warp].sum()
                for j in range(4):
                    idx = x + THREADS * j
                    if j < E and idx < n:
                        valid[idx] = mb[x, j] != 0
                        pre[idx + 1] = run + below[warp, wl, j] + (mb[x, j] != 0)
                    if j + 1 < E:
                        run += wsum[j * warps + warp: j * warps + warps + warp].sum()
            np.testing.assert_array_equal(pre[: n + 1], np.concatenate(
                [[0], np.cumsum(mask[tn * n: tn * n + n] != 0)]))
            # S(0): thread (blk, lane), lane < lanes, over its valid starts;
            # a lane's entries laid out [row r][block][column c]
            red_s = np.full((lanes, BLK, NB, BLK), np.nan, F32)
            taken = np.zeros((n, NB), int)
            for x in range(THREADS):
                blk, lane = x % NB, x // NB
                if lane >= lanes:
                    continue
                bi, bj = blocks[blk]
                acc = np.zeros((BLK, BLK), F32)
                for t in range(lane, n, lanes):
                    if not valid[t]:
                        continue
                    a = ys[t, BLK * bi: BLK * bi + BLK]
                    b = ys[t, BLK * bj: BLK * bj + BLK]
                    acc = (acc + np.outer(a, b)).astype(F32)
                    taken[t, blk] += 1
                assert np.isnan(red_s[lane, :, blk]).all()
                red_s[lane, :, blk] = acc
            assert (taken[valid == 1] == 1).all() and (taken[valid == 0] == 0).all()
            # the window counts, once: entry e = k rows + t
            cnt = np.full(K * rows, np.nan, F32)
            for e in range(K * rows):
                k, t = divmod(e, rows)
                cnt[e] = pre[min(t + 1, n)] - pre[min(max(t + 1 - windows[k], 0), n)]
            # the moment sums: thread (col, mlane) over rows mlane, mlane + ML, ...
            red_m = np.full((ML, 2 * K, tw), np.nan, F32)
            read = np.zeros((rows, tw), int)
            for x in range(THREADS):
                col, mlane = x % tw, x // tw
                m = np.zeros((2, K), F32)
                for t in range(mlane, rows, ML):
                    v = ys[t, col]
                    read[t, col] += 1
                    for k in range(K):
                        wgt = cnt[k * rows + t]
                        m[0, k] = F32(m[0, k] + wgt * v)
                        m[1, k] = F32(m[1, k] + wgt * F32(v * v))
                red_m[mlane, 0::2, col] = m[0]
                red_m[mlane, 1::2, col] = m[1]
            assert (read == 1).all()
            # the row lanes in order: upper entries stored to (i, j) and (j, i)
            s0 = np.full(d * d, np.nan, F32)
            s0_hits = np.zeros(d * d, int)
            for e in range(NB * 16):
                c, b, r = e % BLK, (e // BLK) % NB, e // (BLK * NB)
                ei, ej = blocks[b]
                row, cl = BLK * ei + r, BLK * ej + c
                if (ei == ej and r > c) or row >= d or cl >= d:
                    continue
                v = F32(0)
                for lane in range(lanes):
                    v = F32(v + red_s[lane].reshape(-1)[e])
                s0[row * d + cl] = v
                s0_hits[row * d + cl] += 1
                if row != cl:
                    s0[cl * d + row] = v
                    s0_hits[cl * d + row] += 1
            assert (s0_hits == 1).all()
            for e in range(2 * K * d):
                v = F32(0)
                for lane in range(ML):
                    v = F32(v + red_m[lane, e // d, e % d])
                mom[tn * 2 * K * d + e] = v
                hits["mom"][tn * 2 * K * d + e] += 1
            lag[tn * d * d: (tn + 1) * d * d] = s0
            hits["lag"][tn * d * d: (tn + 1) * d * d] += 1
    return lag.reshape(B, 1, d, d), mom.reshape(B, K, 2, d), hits


def _case(B, n, d, windows, mask_kind, seed=0):
    rng = np.random.default_rng(seed + 7 * B + d + n)
    y = rng.standard_normal((B, n + max(windows) - 1, d)).astype(F32)
    if mask_kind == "all":
        mask = np.ones((B, n), bool)
    elif mask_kind == "none":
        mask = np.zeros((B, n), bool)
    else:
        mask = rng.random((B, n)) < 0.6
    return torch.from_numpy(y), torch.from_numpy(mask)


@functools.lru_cache(maxsize=None)
def _jax_ref(windows):
    return jax.jit(lambda y, m: jref.fused_lag_moments_ref(y, m, 0, windows))


def _close(lag, mom, want, y, mask, windows):
    """S(0) within TOL of each tenant's max|S(0)|; each moment sum within TOL
    of the same sum over |y|."""
    wl, wm = (np.asarray(t, np.float64) for t in want)
    lag = lag.reshape(wl.shape)
    scale_l = np.abs(wl).reshape(wl.shape[0], -1).max(1)
    err_l = np.abs(lag - wl).reshape(wl.shape[0], -1).max(1)
    assert (err_l <= TOL * np.maximum(scale_l, 1e-30)).all(), (err_l, scale_l)
    scale = wsr.fused_lag_moments_ref(y.abs(), mask, 0, windows)[1].double().numpy()
    err = np.abs(mom - wm.reshape(mom.shape))
    assert ((err == 0) | (err <= TOL * scale)).all()


@pytest.mark.parametrize("mask_kind", ["all", "none", "random"])
@pytest.mark.parametrize("windows", [(1,), (32,), (32, 128)])
@pytest.mark.parametrize("B", [2, 5])
@pytest.mark.parametrize("d", [1, 3, 16, 17, 32])
def test_walk_writes_each_output_once_and_matches(d, B, windows, mask_kind):
    n = 61
    y, mask = _case(B, n, d, windows, mask_kind)
    prep = ws.prepare_fused_lag_moments(y, mask, 0, windows)
    p = prep.params
    assert prep.entry == "rt_lag_moments_batched" and p.batch == B and p.rows == y.shape[1]
    assert p.vec == int(d % 4 == 0) and p.n == n and list(p.windows)[: p.K] == list(windows)
    lag, mom, hits = walk(p, y, mask)
    assert all((h == 1).all() for h in hits.values())
    assert np.array_equal(lag[:, 0], np.swapaxes(lag[:, 0], -1, -2))  # exactly symmetric
    _close(lag, mom, wsr.fused_lag_moments_ref(y, mask, 0, windows), y, mask, windows)
    ref = [_jax_ref(windows)(jnp.asarray(y[t].numpy()), jnp.asarray(mask[t].numpy()))
           for t in range(B)]
    _close(lag, mom, (np.stack([r[0] for r in ref]), np.stack([r[1] for r in ref])),
           y, mask, windows)
    if mask_kind == "none":
        assert not lag.any()


@pytest.mark.parametrize("n,d", [(256, 16), (257, 3), (700, 16)])
def test_walk_of_long_masks_counts_every_round(n, d):
    """Masks of more than RT_THREADS starts: each thread holds E = 2 or 3
    bytes, counted round by round; the walk against the plain version."""
    windows = (32,)
    y, mask = _case(2, n, d, windows, "random", seed=5)
    p = ws.prepare_fused_lag_moments(y, mask, 0, windows).params
    lag, mom, hits = walk(p, y, mask)
    assert all((h == 1).all() for h in hits.values())
    _close(lag, mom, wsr.fused_lag_moments_ref(y, mask, 0, windows), y, mask, windows)


@pytest.mark.parametrize("d", [3, 16, 32])
def test_a_tenants_sums_do_not_depend_on_its_cta(d):
    """Tenants per CTA 1, 2 and 4, and batches of 2, 3 and 7: tenant i's
    walked sums are bitwise the same (the session's repeat, restart and
    gateway-twin pins rest on it)."""
    windows = (4, 9)
    y, mask = _case(7, 40, d, windows, "random", seed=3)
    got = []
    for tenants in (1, 2, 4):
        for B in (2, 3, 7):
            saved = ws.LAGMOM_TENANTS
            ws.LAGMOM_TENANTS = tenants
            try:
                p = ws.prepare_fused_lag_moments(y[:B].contiguous(), mask[:B].contiguous(), 0,
                                                 windows).params
            finally:
                ws.LAGMOM_TENANTS = saved
            assert p.tenants == tenants
            lag, mom, _ = walk(p, y[:B], mask[:B])
            got.append((lag[:2], mom[:2]))
    assert all(np.array_equal(g[0], got[0][0]) and np.array_equal(g[1], got[0][1])
               for g in got)


@pytest.mark.parametrize("max_lag,lead,d,rows,path", [
    (0, (), 16, 383, "sym"), (0, (1,), 16, 383, "sym"), (0, (1,), 64, 383, "sym"),
    (0, (2,), 16, 383, "batched"), (0, (4096,), 16, 158, "batched"),
    (0, (2,), 1, 383, "batched"), (0, (2,), 32, 383, "batched"),
    (0, (2,), 33, 383, "two_role"), (0, (2,), 64, 383, "two_role"),
    (1, (2,), 16, 383, "two_role"), (16, (4096,), 16, 383, "two_role"),
    (3, (), 16, 383, "two_role"), (3, (1,), 32, 383, "two_role"),
    (0, (2,), 16, 1024, "batched"), (0, (2,), 16, 1025, "two_role"),
    (0, (2,), 32, 512, "batched"), (0, (2,), 17, 513, "two_role"),
])
def test_routing_takes_each_call_to_its_launch(max_lag, lead, d, rows, path):
    assert ws.lag_moments_path(max_lag, lead, d, rows) == path


@pytest.mark.parametrize("B,d,max_lag,entry", [(1, 16, 0, "rt_lag_moments_sym"),
                                               (2, 16, 0, "rt_lag_moments_batched"),
                                               (2, 32, 0, "rt_lag_moments_batched"),
                                               (2, 33, 0, None), (2, 16, 1, None)])
def test_prepare_follows_the_routing(B, d, max_lag, entry):
    """The wrapper's launch is the route's: the batched entry, the symmetric
    one (which sizes its grid by the card, so it raises on the CPU after its
    checks), or the two-role kernel's own."""
    y, mask = _case(B, 50, d, (8,), "random")
    if entry == "rt_lag_moments_sym":
        with pytest.raises(ValueError, match="CUDA"):
            ws.prepare_fused_lag_moments(y, mask, max_lag, (8,))
        return
    prep = ws.prepare_fused_lag_moments(y, mask, max_lag, (8,), sms=132)
    assert prep.entry == entry
    lead = (B,)
    assert ws.lag_moments_path(max_lag, lead, d, y.shape[1]) == (
        "batched" if entry else "two_role")


def test_session_shapes_fit_the_card():
    """The query tail, the moments-only chunk and merge boundary at d = 16
    and 32: two CTAs in an SM's shared memory at the shipped tenants per
    CTA (the kernel's launch bounds), and the largest batched launch the
    route admits within a CTA's most shared memory."""
    meta = torch.device("meta")
    for d in (16, 32):
        for B, n, windows in ((4096, 127, (32,)), (65536, 256, (32, 128)),
                              (65536, 127, (32, 128))):
            y = torch.empty((B, n + max(windows) - 1, d), device=meta)
            mask = torch.empty((B, n), dtype=torch.bool, device=meta)
            p = ws.prepare_fused_lag_moments(y, mask, 0, windows).params
            floats = smem_floats(p, ws.lag_tile(d))
            assert 2 * (4 * floats + 1024) <= 233472, (d, B, n, floats)
            assert p.lanes == min(THREADS // ((ws.lag_tile(d) // BLK) * (ws.lag_tile(d) // BLK + 1)
                                              // 2), ws.LAGMOM_LANES)
    for tw in (16, 32):  # the largest launch the route admits
        rows = _build.LM_BATCH_SLOT // tw
        p = types.SimpleNamespace(tenants=4, K=_build.MAX_WINDOWS, n=rows, rows=rows, d=tw,
                                  lanes=THREADS // ((tw // BLK) * (tw // BLK + 1) // 2))
        assert 4 * smem_floats(p, tw) <= SMEM_LIMIT, tw


def test_cpu_tensors_run_the_plain_version():
    y, mask = _case(3, 30, 16, (4, 9), "random")
    lag, mom = ws.fused_lagged_moments(y, mask, 0, (4, 9))
    want = wsr.fused_lag_moments_ref(y, mask, 0, (4, 9))
    assert torch.equal(lag, want[0]) and torch.equal(mom, want[1])


def test_batched_constants_and_struct_mirror_the_source():
    """LM_BATCH_SLOT and LM_BATCH_BLK equal _build.py's mirrors and are among
    the constants rt_lagmom_constants writes (the library checks them at
    load); the ctypes LagMomBatchParams names the C struct's fields in order."""
    cu = _CU
    defines = dict(re.findall(r"^#define (LM_BATCH_\w+) (\d+)\b", cu, re.M))
    mirrored = {"LM_BATCH_SLOT": _build.LM_BATCH_SLOT, "LM_BATCH_BLK": _build.LM_BATCH_BLK}
    assert {k: int(defines[k]) for k in mirrored} == mirrored
    assert set(mirrored) <= set(_build.LAGMOM_CONSTANTS.values())
    struct = cu[cu.index("struct LagMomBatchParams {"):]
    struct = struct[: struct.index("};")]
    names = []
    for line in struct.splitlines()[1:]:
        decl = line.split("//")[0].strip()
        if decl:
            fields = re.match(r"(?:const\s+)?(?:unsigned\s+)?\w+\s*\*?\s*(.+);$", decl).group(1)
            names += [re.sub(r"\[.*", "", name).strip() for name in fields.split(",")]
    assert names == [name for name, _ in _build.LagMomBatchParams._fields_]
    assert "rt_lag_moments_batched" in _build.ENTRY_POINTS


def test_variant_points_and_probe_apply_to_the_source():
    """``variants_bench.py session``'s design points of the batched path patch
    #defines that window_stats.cu holds once, set launch-shape knobs that
    ``ops`` has, and its phase probe's anchors are each found once."""
    import importlib.util

    path = _build.REPO_ROOT / "tools" / "kernel_variants" / "variants_bench.py"
    spec = importlib.util.spec_from_file_location("variants_bench", path)
    vb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vb)
    cu = _CU
    assert vb.SESSION_K3_POINTS[0] == ({}, {})
    for defines, knobs in vb.SESSION_K3_POINTS:
        vb._define_source(cu, defines)
        assert all(hasattr(ws, k) for k in knobs)
    probed = vb._patch(cu, vb._SESSION_K3_PROBE_PATCHES, "probe")
    assert probed.count("LB_PROBE(") == len(vb.SESSION_K3_PHASES) + 1
