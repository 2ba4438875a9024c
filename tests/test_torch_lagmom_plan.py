"""Numpy model of kernel 3's symmetric path (H = 0), walked on the CPU.

``lag_moments_sym_kernel`` (``window_stats/csrc/window_stats.cu``) runs only
on the card. This file walks its grid, as ``ops.sym_shape`` gives it, line
for line in numpy: the CTAs of each pair of 64-channel tiles I <= J and each
slab of rows; the cp.async ring's steps of LM_ROWS rows (zero past the
slab), each row's float4 slots swizzled (``lm_slot``); the slab's segments
of the prefix count, which give the start mask and the exact window counts;
each thread's 8 x 8 block of S(0) (the upper blocks of a diagonal pair) over
its row lane; each thread's channel of the moment sums over its row lane;
the row lanes summed in order; the slabs of a cluster in rank
order, CTA ``rank`` summing the rank-th share of the entries; the clusters
of a pair in order, share by share, by whichever CTA arrives last with that
share; every upper entry written at (i, j) and (j, i). The walk checks that
each (entry, slab) is computed once, that the written entries cover d x d
and the K moment rows exactly once, that every staged index lies in range,
that the sums do not depend on the order the CTAs and clusters run in, and
that a slab left out of the sum is caught. Its results are held against the
plain version (``fused_lag_moments_ref``) and the reference's
``fused_lagged_moments`` (``JnpBackend``, and the Pallas kernel in interpret
mode), in float32: S(0) within 1e-5 of max|S(0)|, each moment sum within
1e-5 of the same sum taken over |y| (a first-moment sum cancels;
chip_smoke.py's scale), and against the reference with the f32 tolerances of
tests/test_backend.py (rtol 1e-5, atol 1e-4).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import JnpBackend, PallasBackend
from repro_torch.kernels import _build
from repro_torch.kernels.window_stats import ops as ws, ref as wsr

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

SMS = 132  # the H100's SMs: sym_shape sizes the grid by them
THREADS, TILE, BLK = _build.THREADS, _build.TILE, _build.LM_BLK
F32 = np.float32
TOL = 1e-5
MOM_LANES = THREADS // TILE  # row lanes of the moment sums (one channel a thread)
LAG_TOL = dict(rtol=1e-5, atol=1e-4)  # tests/test_backend.py:167


def slot(f):
    """lm_slot: the float4 slot of a staged row holding channels 4f .. 4f+3."""
    return f ^ ((f >> 3) & 1)


def place(c):
    """Where channel c of a tile lies in a staged row."""
    c = np.asarray(c)
    return 4 * slot(c >> 2) + (c & 3)


def upper_pair(idx, T):
    """upper_pair: (a, b), a <= b, of entry idx of a T x T upper triangle."""
    a = 0
    while idx >= T - a:
        idx -= T - a
        a += 1
    return a, a + idx


class Tile:
    """LmTile: the channel offsets, blocks and row lanes of a tile pair."""

    def __init__(self, s, pair):
        I, J = upper_pair(pair, s["d_tiles"])
        self.diag = I == J
        self.i0, self.j0 = I * TILE, J * TILE
        d = s["d"]
        self.nbi = -(-min(TILE, d - self.i0) // BLK)
        self.nbj = -(-min(TILE, d - self.j0) // BLK)
        self.nblk = self.nbi * (self.nbi + 1) // 2 if self.diag else self.nbi * self.nbj
        self.lanes = THREADS // self.nblk

    def block(self, b):
        return upper_pair(b, self.nbi) if self.diag else divmod(b, self.nbj)


def smem_floats(s):
    """lm_smem_floats: the ring or the threads' tiles, the partial, the
    slab's prefix-count segments, the flag."""
    ring = _build.LM_STAGES * _build.LM_ROWS * TILE * (2 if s["pairs"] > 1 else 1)
    need = (s["K"] + 1) * (s["slab"] + 1)
    return max(ring, THREADS * BLK * BLK) + _build.LM_PART_FLOATS + (need + 3) // 4 * 4 + 4


def cta_of(s, cta):
    """(pair, cluster group g, rank) of CTA ``cta``."""
    C = s["cluster"]
    cl, rank = divmod(cta, C)
    pair, g = divmod(cl, s["groups"])
    return pair, g, rank


def cta_partial(y, prefix, windows, s, cta, log):
    """One CTA: its staged steps, mask and window counts, per-thread blocks
    over row lanes, and the row lanes summed in order.  Returns the CTA's
    partial (float32, entries e = q nblk + b, then the moment sums)."""
    n, rows, d, R = s["n"], s["rows"], s["d"], _build.LM_ROWS
    pair, g, rank = cta_of(s, cta)
    t = Tile(s, pair)
    slab = g * s["cluster"] + rank
    s0 = slab * s["slab"]
    s1 = min(s0 + s["slab"], rows if t.diag else min(rows, n))
    length = max(s1 - s0, 0)
    steps = -(-length // R)
    log["slabs"].append((pair, slab, s0, s1))

    # the staged segments of the prefix count, clamped as the kernel clamps:
    # pre0[i] = prefix[s0 + i] (i <= length), pre_k[i] = prefix[s0 + i + 1 - w_k]
    i = np.arange(length + 1)
    idx0 = np.minimum(s0 + i, n)
    assert idx0.min() >= 0 and idx0.max() <= n
    pre0 = prefix[idx0]
    mask = pre0[1:] - pre0[:-1]  # the start mask of each row (0 from row n on)
    wts = []
    for w in (windows if t.diag else ()):
        idx = np.minimum(np.maximum(s0 + i[:-1] + 1 - w, 0), n)
        assert idx.min(initial=0) >= 0 and idx.max(initial=0) <= n
        wts.append((pre0[1:] - prefix[idx]).astype(F32))
    assert (mask == ((s0 + i[:-1] < n) & np.asarray(
        [row < n and prefix[row + 1] > prefix[row] for row in s0 + i[:-1]]))).all()
    assert length <= _build.LM_MAX_SLAB

    tid = np.arange(THREADS)
    blk, lane = tid % t.nblk, tid // t.nblk
    act = lane < t.lanes
    bi, bj = np.array([t.block(b) for b in blk[act]]).T
    acc = np.zeros((act.sum(), BLK, BLK), F32)
    col, mlane = tid % TILE, tid // TILE
    m1 = np.zeros((len(wts), THREADS), F32)
    m2 = np.zeros((len(wts), THREADS), F32)
    for step in range(steps):
        r0 = s0 + step * R
        src = np.arange(r0, r0 + R)
        live = src < s1
        assert (src[live] < y.shape[0]).all() and (src[live] >= 0).all()
        log["staged"].extend(src[live].tolist())

        def stage(c0):  # swizzled: channel c at place(c)
            out = np.zeros((R, TILE), F32)
            cols = min(TILE, d - c0)
            out[np.ix_(live, place(np.arange(cols)))] = y[src[live], c0: c0 + cols]
            return out

        As = stage(t.i0)
        Bs = As if t.diag else stage(t.j0)
        r_end = min(R, length - step * R)
        for j in range(-(-R // t.lanes)):
            rr = lane[act] + j * t.lanes
            use = rr < r_end
            rr = np.where(use, rr, 0)
            use &= mask[np.minimum(step * R + rr, max(length - 1, 0))] != 0
            a = As[rr[:, None], place((bi * BLK)[:, None] + np.arange(BLK))] * use[:, None]
            b = Bs[rr[:, None], place((bj * BLK)[:, None] + np.arange(BLK))]
            acc += a[:, :, None] * b[:, None, :]
        for j in range(-(-R // MOM_LANES)):
            rr = mlane + j * MOM_LANES
            use = rr < r_end
            rr = np.where(use, rr, 0)
            v = np.where(use, As[rr, place(col)], 0).astype(F32)
            for k, wk in enumerate(wts):
                wgt = wk[np.minimum(step * R + rr, length - 1)]
                m1[k] += wgt * v
                m2[k] += wgt * (v * v)
    # the row lanes in order
    E = t.nblk * BLK * BLK
    red = np.zeros((t.lanes, E), F32)
    q = np.arange(BLK * BLK)
    red[lane[act][:, None], q[None, :] * t.nblk + blk[act][:, None]] = acc.reshape(-1, BLK * BLK)
    assert t.lanes * E <= THREADS * BLK * BLK
    part = np.zeros(E, F32)
    for l in range(t.lanes):
        part += red[l]
    if t.diag:  # the moment sums, their row lanes in order
        M = np.zeros((MOM_LANES, 2 * len(wts), TILE), F32)
        for k in range(len(wts)):
            M[mlane, 2 * k, col] = m1[k]
            M[mlane, 2 * k + 1, col] = m2[k]
        mom = np.zeros(2 * len(wts) * TILE, F32)
        for l in range(MOM_LANES):
            mom += M[l].reshape(-1)
        part = np.concatenate([part, mom])
    assert part.size <= _build.LM_PART_FLOATS
    for e in range(E):
        log["computed"].append((pair, slab, e))
    return part, t


def store(s, t, e, v, lag, mom, writes):
    """lm_store: entry e of a pair's sum to its place (and its mirror)."""
    d = s["d"]
    E = t.nblk * BLK * BLK
    if e < E:
        q, b = divmod(e, t.nblk)
        bi, bj = t.block(b)
        r, c = divmod(q, BLK)
        if t.diag and bi == bj and r > c:
            return
        i, j = t.i0 + bi * BLK + r, t.j0 + bj * BLK + c
        if i < d and j < d:
            lag[i, j] = lag[j, i] = v
            writes["lag"][min(i, j), max(i, j)] += 1
    else:
        em = e - E
        c = t.i0 + em % TILE
        if c < d:
            kw = em // TILE
            mom[kw // 2, kw % 2, c] = v
            writes["mom"][kw // 2, kw % 2, c] += 1


def walk(y, start_mask, windows, s, seed=0, drop_slab=-1):
    """The whole launch: every CTA's partial (in a random order), every
    cluster's rank-order sums (in a random order), each share of a pair's
    final sum by the last CTA to arrive with it.  Returns (S(0) (1, d, d),
    moments (K, 2, d), writes, log)."""
    y = np.asarray(y, F32)
    n, d, K = s["n"], s["d"], s["K"]
    prefix = np.concatenate([[0], np.cumsum(start_mask)]).astype(np.int64)
    C, G, P = s["cluster"], s["groups"], s["pairs"]
    rng = np.random.default_rng(seed)
    log = {"slabs": [], "staged": [], "computed": [], "order": {}}
    parts, tiles = {}, {}
    for cta in rng.permutation(P * G * C):
        parts[cta], tiles[cta] = cta_partial(y, prefix, windows, s, cta, log)
    lag = np.full((d, d), np.nan, F32)
    mom = np.full((K, 2, d), np.nan, F32)
    writes = {"lag": np.zeros((d, d), int), "mom": np.zeros((K, 2, d), int)}
    arrive = np.zeros((P, C), int)
    cluster_sums = {}
    for cl in rng.permutation(P * G):
        pair, g = divmod(cl, G)
        first = cl * C
        t = tiles[first]
        total = parts[first].size
        share = -(-total // C)
        out = np.zeros(total, F32)
        for rank in range(C):  # CTA `rank` sums its share over the ranks in order
            for e in range(rank * share, min((rank + 1) * share, total)):
                v = F32(0)
                for q in range(C):
                    if g * C + q != drop_slab:
                        v = F32(v + parts[first + q][e])
                out[e] = v
        log["order"][cl] = [g * C + q for q in range(C)]
        if G == 1:
            for e in range(total):
                store(s, t, e, out[e], lag, mom, writes)
            continue
        cluster_sums[cl] = out
        for rank in rng.permutation(C):  # the cluster's CTAs count their shares in any order
            arrive[pair, rank] += 1
            if arrive[pair, rank] == G:  # the last with this share: the clusters in order
                arrive[pair, rank] = 0
                for e in range(rank * share, min((rank + 1) * share, total)):
                    v = F32(0)
                    for gg in range(G):
                        v = F32(v + cluster_sums[pair * G + gg][e])
                    store(s, t, e, v, lag, mom, writes)
    assert (arrive == 0).all()  # left at zero for the next launch
    return lag[None], mom, writes, log


def _case(n, d, windows, holes=True, seed=0, extra=0):
    rng = np.random.default_rng(seed + n + d)
    rows = n + max(windows) - 1
    y = rng.standard_normal((rows + extra, d)).astype(F32)
    mask = np.ones(n, bool)
    if holes:
        mask[n // 3:: 5] = False
        mask[-max(1, n // 10):] = False
    return y[:rows], mask


def _shape(n, d, windows, sms=SMS):
    return ws.sym_shape(n, n + max(windows) - 1, d, len(windows), sms)


def _plain(y, mask, windows):
    lag, mom = wsr.fused_lag_moments_ref(torch.from_numpy(y), torch.from_numpy(mask), 0,
                                         tuple(windows))
    scale = wsr.fused_lag_moments_ref(torch.from_numpy(np.abs(y)), torch.from_numpy(mask), 0,
                                      tuple(windows))[1]
    return lag.numpy(), mom.numpy(), scale.numpy()


def _assert_close(lag, mom, want_lag, want_mom, scale):
    assert np.abs(lag - want_lag).max() <= TOL * np.abs(want_lag).max()
    err = np.abs(mom - want_mom)
    assert ((err == 0) | (err <= TOL * scale)).all()


# shapes: (n, d, windows, sms); few SMs give many clusters and groups
GRID = [
    (300, 1, (1,), 4), (300, 3, (5, 64), 4), (200, 63, (64,), 2), (130, 64, (1,), 1),
    (400, 64, (64, 1024), 3), (200, 65, (8,), 2), (120, 130, (3, 8, 17), 1),
    (150, 7, tuple(range(1, 16, 2)), 5), (960, 64, (64,), 8), (70, 200, (4,), 1),
]


@pytest.mark.parametrize("n,d,windows,sms", GRID)
def test_grid_computes_each_entry_and_slab_once_and_writes_d_by_d_once(n, d, windows, sms):
    y, mask = _case(n, d, windows)
    s = _shape(n, d, windows, sms)
    lag, mom, writes, log = walk(y, mask, windows, s)
    # every (pair, slab) one CTA; the diagonal pairs' slabs cover [0, rows)
    slabs = {}
    for pair, slab, s0, s1 in log["slabs"]:
        assert (pair, slab) not in slabs
        slabs[(pair, slab)] = (s0, s1)
    assert len(slabs) == s["pairs"] * s["groups"] * s["cluster"]
    diag_rows = sorted(r for (pair, _), (s0, s1) in slabs.items()
                       if Tile(s, pair).diag and pair == 0 for r in range(s0, s1))
    assert diag_rows == list(range(s["rows"]))
    assert len(set(log["computed"])) == len(log["computed"])
    # every entry of S(0) from one upper entry, every moment row once
    assert (writes["lag"][np.triu_indices(d)] == 1).all()
    assert writes["lag"][np.tril_indices(d, -1)].sum() == 0
    assert (writes["mom"] == 1).all()
    assert np.array_equal(lag[0], lag[0].T)
    # each cluster sums its ranks' slabs in rank order
    for cl, order in log["order"].items():
        g = cl % s["groups"]
        assert order == list(range(g * s["cluster"], (g + 1) * s["cluster"]))


@pytest.mark.parametrize("n,d,windows,sms", GRID)
def test_walk_matches_the_plain_version(n, d, windows, sms):
    y, mask = _case(n, d, windows)
    lag, mom, _, _ = walk(y, mask, windows, _shape(n, d, windows, sms))
    _assert_close(lag, mom, *_plain(y, mask, windows))


@pytest.mark.parametrize("n,d,windows,sms", GRID[:4] + GRID[-2:])
def test_sums_do_not_depend_on_the_order_ctas_and_clusters_run(n, d, windows, sms):
    y, mask = _case(n, d, windows)
    s = _shape(n, d, windows, sms)
    runs = [walk(y, mask, windows, s, seed=seed)[:2] for seed in (1, 2, 3)]
    for lag, mom in runs[1:]:
        assert np.array_equal(lag, runs[0][0]) and np.array_equal(mom, runs[0][1])


@pytest.mark.parametrize("n,d,windows,sms", [(400, 64, (64, 1024), 3), (300, 3, (5, 64), 4),
                                             (120, 130, (3, 8, 17), 1)])
def test_a_slab_left_out_of_the_sum_is_caught(n, d, windows, sms):
    """The planted fault of chip_smoke.py and the card tests: one slab's
    partial left out of the in-launch sum (chip_smoke.LAGMOM_FAULT)."""
    y, mask = _case(n, d, windows)
    s = _shape(n, d, windows, sms)
    want_lag, want_mom, scale = _plain(y, mask, windows)
    middle = (-(-s["rows"] // s["slab"]) - 1) // 2  # a slab that holds rows
    lag, mom, _, _ = walk(y, mask, windows, s, drop_slab=middle)
    lag_rel = np.abs(lag - want_lag).max() / np.abs(want_lag).max()
    mom_rel = (np.abs(mom - want_mom) / np.maximum(scale, 1e-30)).max()
    assert max(lag_rel, mom_rel) > 100 * TOL


@pytest.mark.parametrize("n,d,windows,sms", GRID[:4] + GRID[-2:])
def test_planted_fault_copy_leaves_out_the_walks_middle_slab(n, d, windows, sms):
    """chip_smoke.py's faulty copy of window_stats.cu: its one patched line
    leaves out of the cluster sum the slab that the walk's dropped-slab
    test leaves out (its C expression evaluated on this grid); the shipped
    source has no such switch."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  _build.REPO_ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shipped, faulty = smoke.LAGMOM_FAULT
    text = smoke.lagmom_fault_source()
    assert text.count(faulty) == 1 and shipped not in text
    s = _shape(n, d, windows, sms)
    expr = re.search(r"g \* C \+ q != (.+)\) v \+=", faulty).group(1)
    dropped = eval(expr.replace("p.rows", str(s["rows"])).replace("p.slab", str(s["slab"]))
                   .replace("/", "//"))
    assert dropped == (-(-s["rows"] // s["slab"]) - 1) // 2
    assert 0 <= dropped < s["groups"] * s["cluster"] and dropped * s["slab"] < s["rows"]


def test_the_swizzle_is_a_permutation_and_spreads_the_banks():
    """lm_slot permutes the 16 float4 of a row; the first (second) float4 of
    the 8 blocks of a row lie in 8 distinct groups of 4 banks, so 8 threads
    loading one float4 of 8 different blocks take one wavefront."""
    assert sorted(slot(f) for f in range(16)) == list(range(16))
    for half in (0, 1):
        groups = {(4 * slot(2 * b + half)) % 32 // 4 for b in range(8)}
        assert len(groups) == 8
    assert sorted(place(np.arange(64)).tolist()) == list(range(64))


def test_window_counts_are_the_valid_starts_each_row_serves():
    """c_w(t) from the prefix count equals the number of valid starts s in
    [t - w + 1, t] (each row's weight in sum_s m_s sum_{j<w} y_{s+j})."""
    n, w = 90, 17
    _, mask = _case(n, 2, (w,))
    prefix = np.concatenate([[0], np.cumsum(mask)])
    for t in range(n + w - 1):
        hi, lo = prefix[min(t + 1, n)], prefix[min(max(t + 1 - w, 0), n)]
        assert hi - lo == sum(mask[s] for s in range(max(0, t - w + 1), min(t + 1, n)))


@pytest.mark.parametrize("window", [(64,), (3, 8, 17)])
def test_walk_matches_the_reference_jnp_backend(window):
    n, d = 200, 5
    y, mask = _case(n, d, window)
    lag, mom, _, _ = walk(y, mask, window, _shape(n, d, window, 3))
    lag_w, mom_w = JnpBackend().fused_lagged_moments(jnp.asarray(y), jnp.asarray(mask), 0,
                                                     window)
    np.testing.assert_allclose(lag, np.asarray(lag_w), **LAG_TOL)
    np.testing.assert_allclose(mom, np.asarray(mom_w), **LAG_TOL)


def test_walk_matches_the_pallas_kernel_in_interpret_mode():
    n, d, window = 60, 2, (4, 9)
    y, mask = _case(n, d, window)
    lag, mom, _, _ = walk(y, mask, window, _shape(n, d, window, 2))
    pal = PallasBackend(block_t=32, block_s=2, interpret=True)
    lag_p, mom_p = pal.fused_lagged_moments(jnp.asarray(y), jnp.asarray(mask), 0, window)
    np.testing.assert_allclose(lag, np.asarray(lag_p), **LAG_TOL)
    np.testing.assert_allclose(mom, np.asarray(mom_p), **LAG_TOL)


def test_main_path_shapes():
    """The chunk (66,559 rows, 65,536 starts, windows (64, 1,024)): one
    wave, as many clusters of 16 as the H100 holds at once (14, at two CTAs
    per SM); the merge boundary and the tail: a few clusters of short
    slabs."""
    chunk = ws.sym_shape(65536, 65536 + 1023, 64, 2, SMS, resident=14)
    assert chunk["pairs"] == 1 and chunk["cluster"] == _build.LM_MAX_CLUSTER == 16
    assert chunk["groups"] == 14
    ctas = chunk["groups"] * chunk["cluster"]
    assert (ctas - 1) * chunk["slab"] < chunk["rows"] <= ctas * chunk["slab"]
    free = ws.sym_shape(65536, 65536 + 1023, 64, 2, SMS)  # no cap: about two CTAs per SM
    assert free["groups"] * free["cluster"] < 2 * SMS + _build.LM_MAX_CLUSTER
    for rows, n in ((1086, 1023), (2046, 1023)):  # the tail, the boundary
        s = ws.sym_shape(n, rows, 64, 1, SMS)
        assert s["slab"] == ws.LAGMOM_MIN_SLAB and s["cluster"] == _build.LM_MAX_CLUSTER
        slabs = -(-rows // s["slab"])
        assert s["groups"] == -(-slabs // s["cluster"])



@pytest.mark.parametrize("d", [1, 64, 65, 130, 1000])
@pytest.mark.parametrize("K", [1, 8])
def test_shared_memory_and_thread_layout_fit(d, K):
    for rows in (100, 1086, 66559, 10**6):
        s = ws.sym_shape(rows, rows, d, K, SMS)
        assert s["slab"] <= _build.LM_MAX_SLAB and 1 <= s["cluster"] <= _build.LM_MAX_CLUSTER
        assert s["groups"] * s["cluster"] * s["slab"] >= rows
        floats = smem_floats(s)
        assert 4 * floats <= 232448
        if s["pairs"] == 1:  # two CTAs per SM: the kernel's launch bounds
            assert 2 * (4 * floats + 1024) <= 233472
        for pair in range(min(s["pairs"], 50)):
            t = Tile(s, pair)
            assert 1 <= t.nblk <= 64 and t.lanes * t.nblk <= THREADS
            moments = 2 * K * TILE if t.diag else 0
            assert t.nblk * BLK * BLK + moments <= _build.LM_PART_FLOATS


def test_python_constants_match_the_c_defines():
    """_build.LAGMOM_CONSTANTS against window_stats.cu's #defines, and
    rt_lagmom_constants writes them in the mirror's order; the ctypes
    mirror of LagMomParams names the C struct's fields in order."""
    cu = (_build.KERNELS_DIR / "window_stats" / "csrc" / "window_stats.cu").read_text()
    defines = dict(re.findall(r"^#define (LM_\w+) (\d+)\b", cu, re.M))
    assert ({name: int(defines[macro]) for name, macro in _build.LAGMOM_CONSTANTS.items()}
            == {name: getattr(_build, name) for name in _build.LAGMOM_CONSTANTS})
    body = cu[cu.index("void rt_lagmom_constants"):]
    assert (re.findall(r"LM_\w+", body[body.index("{"): body.index("};")])
            == list(_build.LAGMOM_CONSTANTS.values()))
    struct = cu[cu.index("struct LagMomParams {"):]
    struct = struct[: struct.index("};")]
    names = []
    for line in struct.splitlines()[1:]:
        decl = line.split("//")[0].strip()
        if decl:
            fields = re.match(r"(?:const\s+)?\w+\s*\*?\s*(.+);$", decl).group(1)
            names += [re.sub(r"\[.*", "", name).strip() for name in fields.split(",")]
    assert names == [name for name, _ in _build.LagMomParams._fields_]


def test_prepare_on_the_cpu_raises_and_the_wrapper_runs_the_plain_version():
    y, mask = _case(50, 3, (4,))
    with pytest.raises(ValueError, match="CUDA"):
        ws.prepare_fused_lag_moments(torch.from_numpy(y), torch.from_numpy(mask), 0, (4,))
    lag, mom = ws.fused_lagged_moments(torch.from_numpy(y), torch.from_numpy(mask), 0, (4,))
    want = wsr.fused_lag_moments_ref(torch.from_numpy(y), torch.from_numpy(mask), 0, (4,))
    assert torch.equal(lag, want[0]) and torch.equal(mom, want[1])


def test_variant_points_apply_to_the_source():
    """Every design point that ``variants_bench.py lagmom`` times patches
    #defines that window_stats.cu holds once, and each launch-shape
    constant it sets is one of ``ops``'; the first point is the shipped
    design; every ablation's anchor is in the source once."""
    import importlib.util

    path = _build.REPO_ROOT / "tools" / "kernel_variants" / "variants_bench.py"
    spec = importlib.util.spec_from_file_location("variants_bench", path)
    vb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vb)
    text = (_build.KERNELS_DIR / "window_stats" / "csrc" / "window_stats.cu").read_text()
    assert vb.LAGMOM_POINTS[0] == ({}, {})
    for defines, knobs in vb.LAGMOM_POINTS:
        if "VARIANT" in defines:  # rows staged as they lie are read as they lie
            patched = vb._patch(text, vb.LAGMOM_VARIANTS[defines["VARIANT"]], "variant")
            assert "lm_stage_rows(As" not in patched
            assert "int lm_slot(int f) { return f; }" in patched
            continue
        patched = vb._define_source(text, defines)
        for name, value in defines.items():
            assert re.findall(rf"^#define {name} (\d+)", patched, re.M) == [str(value)]
        assert all(hasattr(ws, k) for k in knobs)
    vb._patch(text, vb._LAGMOM_ABLATION_PATCHES, "ablations")  # each anchor found once
