"""The index arithmetic of the redesigned kernels 1-4, rehearsed on the CPU.

The CUDA kernels build and run only on the card, so this file holds numpy
models of their index arithmetic, line for line, and checks them against
plain results: the FFT path of the Welch power (``welch_fft_role`` in
``kernels/csrc/stats_tiles.cuh``: per-channel means, radix-4 / radix-2
Stockham stages in place over two-channel complex sequences, roots from the
host's (L/2)-entry table, the two-for-one split) against ``numpy.fft.rfft``
for every power of two up to ``FFT_MAX_L``; the lag contraction's grid
(``lag_role`` on the 64-channel tile, ``small_lag_role`` on a tile sized by
d at d <= 32: every (lag, channel tile, slab) exactly once) and its staged
sliding window (``lag_group`` / ``lag_step``, ``small_lag_group`` /
``small_lag_step``: staged rows in range, each output's starts in
ascending order) against the plain lag sums; the host roots table against
float64; and the path chosen for each length.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.segment_dft.ref import fft_roots_host
from repro_torch.kernels.window_stats.ref import masked_lagged_sums_ref

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

POWERS = [2**k for k in range(1, 13)]  # 2 .. FFT_MAX_L
THREADS = _build.THREADS
# per-thread register arrays of the kernel (stats_tiles.cuh)
FFT_OUT = (_build.FFT_FLOATS // 4 + _build.FFT_MAX_CHAN // 2 + THREADS - 1) // THREADS


def _roots(L):
    r = fft_roots_host(L).astype(np.float64)
    return r[:, 0] + 1j * r[:, 1]


def _butterfly(v, R):
    """out_r = sum_q v_q W_R^(q r), v (n, R) -- the kernel's butterfly<R>."""
    if R == 2:
        return np.stack([v[:, 0] + v[:, 1], v[:, 0] - v[:, 1]], 1)
    s02, d02 = v[:, 0] + v[:, 2], v[:, 0] - v[:, 2]
    s13, d13 = v[:, 1] + v[:, 3], v[:, 1] - v[:, 3]
    return np.stack([s02 + s13, d02 - 1j * d13, s02 - s13, d02 + 1j * d13], 1)


def fft_tile_model(seg, taper, detrend):
    """welch_fft_role on one (L, C) tile, in float64: returns the (F, C)
    power, each channel's |rfft((y - mean) * taper)|^2."""
    L, C = seg.shape
    P = C // 2
    lp = P.bit_length() - 1
    half = L // 2
    roots = _roots(L)

    def root(k):  # fft_root: W^k for k < L from the half table
        w = roots[k & (half - 1)]
        return np.where(k < half, w, -w)

    # channel_means: RT_THREADS / C row lanes, then the lanes in order
    lanes = THREADS // C
    red = np.zeros((lanes, C))
    if detrend:
        for lane in range(lanes):
            red[lane] = seg[lane::lanes].sum(0)
    mu = red.sum(0) / L if detrend else np.zeros(C)

    buf = (seg[:, 0::2] + 1j * seg[:, 1::2]).reshape(-1)  # z[t][q] at t << lp | q
    Ns, first = 1, True
    while Ns < L:
        R = 4 if L // Ns >= 4 else 2
        nb = (L // R) << lp
        assert nb <= (_build.FFT_FLOATS // 2 // THREADS // R) * THREADS  # PER butterflies
        stride, span = L // R, L // (Ns * R)
        b = np.arange(nb)
        q, j = b & (P - 1), b >> lp
        k = j & (Ns - 1)
        v = np.empty((nb, R), complex)
        for r in range(R):
            t = j + r * stride
            x = buf[(t << lp) + q]
            if first:
                x = ((x.real - mu[2 * q]) + 1j * (x.imag - mu[2 * q + 1])) * taper[t]
            elif r > 0:
                x = x * root(r * k * span)
            v[:, r] = x
        v = _butterfly(v, R)
        d0 = (j - k) * R + k
        for r in range(R):
            buf[((d0 + r * Ns) << lp) + q] = v[:, r]
        Ns, first = Ns * R, False

    # split_power: pairs e = (f, q), e < F << lp, RT_FFT_OUT per thread
    F = half + 1
    assert F << lp <= FFT_OUT * THREADS
    e = np.arange(F << lp)
    f, q = e >> lp, e & (P - 1)
    zf, zc = buf[(f << lp) + q], buf[(((L - f) & (L - 1)) << lp) + q]
    out = np.zeros((F, C))
    out[f, 2 * q] = 0.25 * np.abs(zf + np.conj(zc)) ** 2
    out[f, 2 * q + 1] = 0.25 * np.abs(zf - np.conj(zc)) ** 2
    return out


@pytest.mark.parametrize("d", [1, 5, 64])
@pytest.mark.parametrize("L", POWERS)
def test_fft_index_model_matches_numpy_rfft(L, d):
    rng = np.random.default_rng(L + d)
    C = _launch.fft_channels(L, d)
    assert C >= 2 and C & (C - 1) == 0 and L * C <= _build.FFT_FLOATS
    seg = rng.standard_normal((L, C)) + 3.0
    seg[:, d:] = 0.0  # channels past d are zero-filled by the copies
    taper = np.hanning(L + 2)[1:-1] if L > 2 else np.ones(L)
    for detrend in (True, False):
        want_in = seg - seg.mean(0) if detrend else seg
        want = np.abs(np.fft.rfft(want_in * taper[:, None], axis=0)) ** 2
        got = fft_tile_model(seg, taper, detrend)
        # float32 roots: about 1e-7 relative; an index fault moves a bin by O(1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("L", [2, 8, 256, 4096, 65536])
def test_roots_table_against_float64(L):
    """exp(-2 pi i k / L), k < L/2, within one float32 ulp of float64."""
    got = fft_roots_host(L)
    k = np.arange(L // 2)
    want = np.stack([np.cos(2 * np.pi * k / L), -np.sin(2 * np.pi * k / L)], 1)
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert got.dtype == np.float32 and got.shape == (L // 2, 2)
    assert (np.abs(got.astype(np.float64) - want) <= ulp).all()


@pytest.mark.parametrize("L,path", [(1, "twiddle"), (2, "fft"), (17, "twiddle"),
                                    (24, "twiddle"), (255, "twiddle"), (256, "fft"),
                                    (4096, "fft"), (8192, "twiddle"), (13, "twiddle")])
def test_welch_path_by_length(L, path):
    assert _launch.welch_path(L) == path


def test_fft_tile_fits_shared_memory_and_registers():
    """Every FFT-path length and width: the (L, chan) tile within FFT_FLOATS,
    the CTA's two tiles plus means within the card's 227 KB, and the split's
    (f, sequence) pairs within RT_FFT_OUT per thread."""
    for L in POWERS:
        for d in (1, 2, 3, 63, 64, 65, 130, 1000):
            C = _launch.fft_channels(L, d)
            assert L * C <= _build.FFT_FLOATS and C <= _build.FFT_MAX_CHAN
            assert (2 * L * C + THREADS + _build.FFT_MAX_CHAN) * 4 <= 232448
            assert (L // 2 + 1) * (C // 2) <= FFT_OUT * THREADS


def _welch_params(S, L, d, path):
    y = torch.zeros((S * L, d))
    p = _launch.new_params(y, 0)
    part, out, ops = _launch.add_welch(p, torch.ones(L), None, S, 1, L, 4, y.device,
                                       out=torch.zeros((S, L // 2 + 1, d)), path=path)
    return p


@pytest.mark.parametrize("L,d", [(256, 64), (256, 1), (4096, 130), (2, 7)])
def test_add_welch_fft_grid(L, d):
    p = _welch_params(9, L, d, None)
    m = p.welch[0]
    assert m.fft == 1 and m.chan == _launch.fft_channels(L, d)
    assert m.chan_tiles * m.chan >= d > (m.chan_tiles - 1) * m.chan
    assert m.n_groups == 3 and m.ctas == m.n_groups * m.chan_tiles
    assert m.taper and m.roots and not m.cos


def test_add_welch_twiddle_grid_and_fft_refusal():
    p = _welch_params(9, 17, 70, None)
    m = p.welch[0]
    assert m.fft == 0 and m.cos and not m.roots and m.f_tiles == 1 and m.ctas == 3 * 1 * 2
    with pytest.raises(ValueError, match="power of two"):
        _welch_params(3, 24, 2, "fft")


def _lag_params(n, d, H, sms=132, tile=None):
    y = torch.zeros((n + H, d))
    p = _launch.new_params(y, n)
    _launch.add_lag(p, H, sms, y.device, tile)
    return p


def _run_limit(p):
    """Most lags a CTA of the launch's lag role takes."""
    return _build.LAG_GROUP if p.lag_tile == _build.TILE else _build.SMALL_LAGS


def lag_cta(p, cta):
    """(slab, first lag, lag count, row tile i0, column tile j0) of lag CTA
    ``cta``: the role's decomposition (``lag_role`` on 64-channel tiles,
    ``small_lag_role`` on the one tile of p.lag_tile channels), the channel
    tile fastest, then the lag run, then the slab; the first (H+1) %
    lag_groups runs hold one lag more."""
    tiles = -(-p.d // p.lag_tile)
    tile, rest = cta % tiles**2, cta // tiles**2
    grp, slab = rest % p.lag_groups, rest // p.lag_groups
    base, extra = divmod(p.H + 1, p.lag_groups)
    return (slab, grp * base + min(grp, extra), base + (grp < extra),
            (tile // tiles) * p.lag_tile, (tile % tiles) * p.lag_tile)


@pytest.mark.parametrize("d", [1, 16, 17, 32, 33, 64, 130])
@pytest.mark.parametrize("H", [0, 16, 40])
@pytest.mark.parametrize("n", [65536, 24])
def test_lag_grid_covers_every_lag_tile_and_slab_once(n, H, d):
    p = _lag_params(n, d, H)
    assert p.lag_tile == _launch.lag_tile(d) == (16 if d <= 16 else 32 if d <= 32 else 64)
    seen = {}
    for cta in range(p.lag_ctas):
        slab, h0, ng, i0, j0 = lag_cta(p, cta)
        assert 1 <= ng <= _run_limit(p)
        for h in range(h0, h0 + ng):
            key = (slab, h, i0, j0)
            seen[key] = seen.get(key, 0) + 1
    tiles = [t * p.lag_tile for t in range(-(-d // p.lag_tile))]
    want = {(s, h, i, j) for s in range(p.lag_slabs) for h in range(H + 1)
            for i in tiles for j in tiles}
    assert set(seen) == want and set(seen.values()) == {1}
    # the slabs cover the starts [0, n) and none is empty
    assert p.lag_slab % _build.KC == 0
    assert (p.lag_slabs - 1) * p.lag_slab < n <= p.lag_slabs * p.lag_slab


def test_main_path_lag_grid_fills_two_ctas_per_sm():
    p = _lag_params(65536, 64, 16)
    assert p.lag_tile == _build.TILE
    assert p.lag_groups == -(-17 // _build.LAG_GROUP)
    assert 2 * 132 - p.lag_groups <= p.lag_ctas <= 2 * 132


@pytest.mark.parametrize("d", [3, 16, 17, 32])
def test_small_widths_take_one_run_and_one_tile_for_h16(d):
    """At d <= 32 H = 16 is one CTA a slab (17 lags in one run of
    small_lag_role), and kernel 3's tile (passed as TILE) keeps lag_role's
    runs of LAG_GROUP."""
    p = _lag_params(65536, d, 16)
    assert p.lag_groups == 1 and p.lag_ctas == p.lag_slabs
    assert _lag_params(65536, d, 17).lag_groups == 2
    k3 = _lag_params(65536, d, 16, tile=_build.TILE)
    assert k3.lag_tile == _build.TILE and k3.lag_groups == -(-17 // _build.LAG_GROUP)


def lag_group_model(y, a, m, n, H, h0, ng, i0, j0, slab, lag_slab):
    """lag_group on the CPU: the ring's steps of RT_KC rows, the row mask as
    zero-fill, y rows past b_end zero, and the sliding window of NG fragments
    (row k + g of the staged y for lag h0 + g).  Returns acc (ng, 64, 64)."""
    KC, T = _build.KC, _build.TILE
    d = y.shape[1]
    t_begin = slab * lag_slab
    t_end = min(t_begin + lag_slab, n)
    b_end = t_end + h0 + ng - 1
    steps = -(-(t_end - t_begin) // KC)
    A = a if a is not None else y
    acc = np.zeros((ng, T, T))

    def rows(src, first, count, live, c0):
        out = np.zeros((count, T))
        for r in range(count):
            t = first + r
            if live(t):
                cols = min(T, d - c0)
                if cols > 0:
                    out[r, :cols] = src[t, c0: c0 + cols]
        return out

    for s in range(steps):
        t0 = t_begin + s * KC
        As = rows(A, t0, KC, lambda t: t < t_end and (a is not None or m is None or m[t] != 0),
                  i0)
        Bs = rows(y, t0 + h0, KC + ng - 1, lambda t: t < b_end, j0)
        window = [Bs[g] for g in range(ng - 1)] + [None]
        for k in range(KC):
            window[(k + ng - 1) % ng] = Bs[k + ng - 1]
            for g in range(ng):
                acc[g] += np.outer(As[k], window[(k + g) % ng])
    return acc


def small_lag_model(y, a, m, n, H, h0, ng, slab, lag_slab, TW):
    """small_lag_group on the CPU: the ring's steps of RT_KC rows, a's rows
    zero-filled by the mask (masked starts still multiply), y rows past
    b_end zero, columns past d zero, and thread (i, j)'s sliding window of
    ng values of column j (row k + g of the staged y for lag h0 + g).
    Returns acc (ng, TW, TW), the starts each lag summed in order, and the
    source rows staged of a and of y."""
    KC = _build.KC
    d = y.shape[1]
    t_begin = slab * lag_slab
    t_end = min(t_begin + lag_slab, n)
    b_end = t_end + h0 + ng - 1
    steps = -(-(t_end - t_begin) // KC)
    A = a if a is not None else y
    acc = np.zeros((ng, TW, TW))
    order = [[] for _ in range(ng)]
    staged = {"a": [], "y": []}

    def rows(src, first, count, live, tag):
        out = np.zeros((count, TW))
        for r in range(count):
            t = first + r
            if live(t):
                staged[tag].append(t)
                out[r, :min(TW, d)] = src[t, :min(TW, d)]
        return out

    for s in range(steps):
        t0 = t_begin + s * KC
        As = rows(A, t0, KC, lambda t: t < t_end and (a is not None or m is None or m[t] != 0),
                  "a")
        Bs = rows(y, t0 + h0, KC + ng - 1, lambda t: t < b_end, "y")
        window = [Bs[g] for g in range(ng - 1)] + [None]
        for k in range(KC):
            window[(k + ng - 1) % ng] = Bs[k + ng - 1]
            for g in range(ng):
                acc[g] += np.outer(As[k], window[(k + g) % ng])
                if t0 + k < t_end:
                    order[g].append(t0 + k)
    return acc, order, staged


@pytest.mark.parametrize("n,d,H,masked", [(100, 3, 5, True), (24, 2, 9, False),
                                          (300, 70, 16, True), (70, 1, 0, True),
                                          (1000, 2, 7, True),  # several slabs
                                          (203, 16, 16, True), (203, 17, 40, True),
                                          (300, 33, 3, True), (700, 32, 17, True)])
def test_lag_staging_model_matches_plain_lag_sums(n, d, H, masked):
    """Each lag CTA's model (lag_group_model on the 64-channel tile,
    small_lag_model on a tile sized by d) writes its outputs once; the
    small role's staged rows lie in range and each output sums its starts
    in ascending order; the sums match the plain lag sums."""
    rng = np.random.default_rng(n + H)
    y = rng.standard_normal((n + H, d))
    mask = np.ones(n, dtype=bool)
    if masked:
        mask[n // 3:: 5] = False
    p = _lag_params(n, d, H, sms=4)  # few SMs: slabs of a few hundred starts
    got = np.zeros((p.lag_slabs, H + 1, d, d))
    hits = np.zeros(got.shape, int)
    for cta in range(p.lag_ctas):
        slab, h0, ng, i0, j0 = lag_cta(p, cta)
        if p.lag_tile == _build.TILE:
            acc = lag_group_model(y, None, mask.astype(np.float64), n, H, h0, ng, i0, j0, slab,
                                  p.lag_slab)
        else:
            acc, order, staged = small_lag_model(y, None, mask.astype(np.float64), n, H, h0, ng,
                                                 slab, p.lag_slab, p.lag_tile)
            starts = list(range(slab * p.lag_slab, min((slab + 1) * p.lag_slab, n)))
            assert all(o == starts for o in order)  # every start, ascending
            assert all(0 <= t < n for t in staged["a"])
            assert all(0 <= t < n + H for t in staged["y"])
        ni, nj = min(p.lag_tile, d - i0), min(p.lag_tile, d - j0)
        got[slab, h0: h0 + ng, i0: i0 + ni, j0: j0 + nj] = acc[:, :ni, :nj]
        hits[slab, h0: h0 + ng, i0: i0 + ni, j0: j0 + nj] += 1
    assert (hits == 1).all()
    head = np.where(mask[:, None], y[:n], 0.0)
    want = np.stack([head.T @ y[h: h + n] for h in range(H + 1)])
    np.testing.assert_allclose(got.sum(0), want, rtol=1e-10, atol=1e-10)
    # and the port's plain version, in its float32
    plain = masked_lagged_sums_ref(torch.from_numpy(y), torch.from_numpy(mask), H).numpy()
    np.testing.assert_allclose(got.sum(0), plain, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_small_lag_model_keeps_a_nan_in_a_masked_starts_reach():
    """A masked start's a row is zero-filled and still multiplies: a NaN in
    y at a row only masked starts reach gives NaN in S(h), as the plain
    version's where-then-einsum does."""
    n, d, H = 100, 16, 16
    y = np.random.default_rng(0).standard_normal((n + H, d))
    mask = np.ones(n)
    mask[20:60] = 0
    y[40, 2] = np.nan
    p = _lag_params(n, d, H, sms=4)
    acc, _, _ = small_lag_model(y, None, mask, n, H, 0, H + 1, 0, p.lag_slab, p.lag_tile)
    plain = masked_lagged_sums_ref(torch.from_numpy(y), torch.from_numpy(mask > 0), H).numpy()
    np.testing.assert_array_equal(np.isfinite(acc[:, :d, :d]), np.isfinite(plain))
    assert not np.isfinite(plain).all()
