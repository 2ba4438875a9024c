"""Numpy model of the batched launches of kernels 1-3, walked on the CPU.

A multi-tenant session's ingest launches kernel 1 (``fused_plan_kernel``)
once for an arrival batch of B tenants, and its batched finalize launches
kernels 2 (``cross_lag_kernel``) and 3 once for all queried tenants (at
H > 0 or d > 32 ``fused_lag_moments_kernel``, walked here; its batched path
at H = 0 is walked in tests/test_torch_lagmom_batched.py).  Those kernels run only on the card; this file
walks their batched grid as the wrappers fill it (``prepare_*`` with a given
SM count fill the params on any device): the tenant folded into blockIdx.x
(tenant-major, ``tenant_ctas`` role CTAs a tenant), each role's pointers
offset by its tenant's 64-bit strides, every partial written once, the
fixed-order reduction of each tenant's partials (stats_tiles.cuh's
``reduce_parts_kernel``) writing every output once, the launch at B =
65,536 on one 1-D grid, and batch 1 the one-problem decomposition.  At
d <= 32 kernels 1 and 2 take the lag tile sized by d (``small_lag_role``:
one tile, runs of up to SMALL_LAGS lags), whose CTAs write a tenant's sums
directly where it has one slab (the reduction skips them).  The
walk's sums are held against the plain versions and the reference's
``JnpBackend`` per tenant (rtol 1e-5, atol 1e-4: tests/test_backend.py's
f32 tolerances).
"""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import JnpBackend
from repro.kernels.window_stats import ops as ref_ws
from repro_torch.kernels import _build
from repro_torch.kernels.fused_plan import ops as fp, ref as fpr
from repro_torch.kernels.segment_dft.ref import segment_dft_power_ref
from repro_torch.kernels.window_stats import ops as ws, ref as wsr

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

SMS = 132  # the H100's SMs: the wrappers size the grid by them
TILE = _build.TILE
F32 = np.float32
TOL = dict(rtol=1e-5, atol=1e-4)
INT32_MAX = 2**31 - 1


def _operands(B, L, d, reach, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((B, L + reach, d)).astype(F32)
    mask = rng.random((B, L)) < 0.8
    z0 = rng.integers(0, 1000, B).astype(np.int32)
    return torch.from_numpy(y), torch.from_numpy(mask), torch.from_numpy(z0)


def _hann(L):
    return 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(L) / L)


def tenant_ctas(p):
    return p.lag_ctas + p.mom_ctas + sum(p.welch[j].ctas for j in range(p.n_welch))


def roles(p, ctas_of_tenant):
    """(tenant, role, role index, Welch member) of every CTA of the grid:
    blockIdx.x = tenant * tenant_ctas + role CTA, lag CTAs first, then
    moment CTAs, then each Welch member's (fused_plan_kernel's dispatch)."""
    out = []
    for b in range(p.batch * ctas_of_tenant):
        tn, r = divmod(b, ctas_of_tenant)
        if r < p.lag_ctas:
            out.append((tn, "lag", r, None))
            continue
        r -= p.lag_ctas
        if r < p.mom_ctas:
            out.append((tn, "mom", r, None))
            continue
        r -= p.mom_ctas
        for j in range(p.n_welch):
            if r < p.welch[j].ctas:
                out.append((tn, "welch", r, j))
                break
            r -= p.welch[j].ctas
    return out


def lag_cta(p, cta):
    """(slab, first lag, lag count, i0, j0): the lag role's decomposition on
    tiles of p.lag_tile channels (lag_role at TILE, small_lag_role's one
    tile below)."""
    tiles = -(-p.d // p.lag_tile)
    tile, rest = cta % tiles**2, cta // tiles**2
    grp, slab = rest % p.lag_groups, rest // p.lag_groups
    base, extra = divmod(p.H + 1, p.lag_groups)
    return (slab, grp * base + min(grp, extra), base + (grp < extra),
            (tile // tiles) * p.lag_tile, (tile % tiles) * p.lag_tile)


def lag_direct(prep):
    """True if the launch's lag CTAs write the output itself (one slab a
    tenant on the small tile): its lag partials are its lag output."""
    p = prep.params
    return p.lag_tile != TILE and p.lag_slabs == 1 and prep.keep[2] is (
        prep.out[0] if isinstance(prep.out, tuple) else prep.out)


def lag_sums(p, lag_part, direct):
    """The lag output of a walked launch: the partials themselves where the
    CTAs wrote the output, else reduce_section's sums (checked to write
    every output once and read in range)."""
    if direct:
        return lag_part.astype(F32)
    lag, hits, ok = reduce_section(lag_part, p.batch, p.lag_slabs, (p.H + 1) * p.d * p.d,
                                   p.lag_part_stride, p.lag_out_stride)
    assert ok and (hits == 1).all()
    return lag


def walk(p, y, mask, offs, taper_of=None, a=None):
    """Every CTA of the batched grid in numpy: the partial buffers it
    writes (flat, by each role's 64-bit tenant offset) and how often each
    element is written.  ``offs`` holds each Welch member's (B, n_entries)
    candidate table; ``a`` the lag family's left factor (kernel 2: the
    mask-zeroed head, every row live), else ``y`` masked by ``mask``."""
    B, d, n, H = p.batch, p.d, p.n, p.H
    y, m = y.numpy().astype(np.float64), mask.numpy()
    left = y if a is None else a.numpy().astype(np.float64)
    lag_part = np.zeros(B * p.lag_part_stride)
    lag_hits = np.zeros(B * p.lag_part_stride, int)
    mom_part = np.zeros(max(B * p.mom_part_stride, 1))
    mom_hits = np.zeros(max(B * p.mom_part_stride, 1), int)
    welch_part = [np.zeros(B * p.welch[j].part_stride) for j in range(p.n_welch)]
    welch_hits = [np.zeros(B * p.welch[j].part_stride, int) for j in range(p.n_welch)]
    prefix = np.concatenate([np.zeros((B, 1), int), np.cumsum(m, 1)], 1)
    for tn, role, r, j in roles(p, tenant_ctas(p)):
        if role == "lag":
            slab, h0, ng, i0, j0 = lag_cta(p, r)
            ts = np.arange(slab * p.lag_slab, min(slab * p.lag_slab + p.lag_slab, n))
            if a is None:
                ts = ts[m[tn, ts]]
            ii = np.arange(i0, min(i0 + p.lag_tile, d))
            jj = np.arange(j0, min(j0 + p.lag_tile, d))
            for h in range(h0, h0 + ng):
                s = left[tn, ts][:, ii].T @ y[tn, ts + h][:, jj]
                addr = (tn * p.lag_part_stride + (slab * (H + 1) + h) * d * d
                        + ii[:, None] * d + jj[None, :])
                lag_part[addr] = s
                lag_hits[addr] += 1
        elif role == "mom":
            cg, slab = r % p.c_groups, r // p.c_groups
            cc = np.arange(cg * 32, min(cg * 32 + 32, d))
            rows = np.arange(slab * p.mom_slab, min(slab * p.mom_slab + p.mom_slab, p.mom_rows))
            hi = prefix[tn, np.minimum(rows + 1, n)]
            for k in range(p.K):
                lo = np.clip(rows + 1 - p.windows[k], 0, n)
                wgt = (hi - prefix[tn, lo]).astype(np.float64)[:, None]
                v = y[tn, rows][:, cc]
                for q, val in enumerate(((wgt * v).sum(0), (wgt * v * v).sum(0))):
                    addr = tn * p.mom_part_stride + (slab * p.K + k) * 2 * d + q * d + cc
                    mom_part[addr] = val
                    mom_hits[addr] += 1
        else:  # the FFT path: CTA (channel tile, group of candidate entries)
            w = p.welch[j]
            ct, g = r % w.chan_tiles, r // w.chan_tiles
            cc = np.arange(ct * w.chan, min(ct * w.chan + w.chan, d))
            acc = np.zeros((w.F, len(cc)))
            for e in range(g * w.group, min((g + 1) * w.group, w.n_entries)):
                off = int(offs[j][tn, e])
                if off < 0:
                    continue
                row = (e // w.n_cand) * w.tile + off
                seg = torch.from_numpy(y[tn, row: row + w.L][:, cc].astype(F32))
                acc += segment_dft_power_ref(seg[None], taper_of(w.L))[0].double().numpy()
            f = np.arange(w.F)
            addr = tn * w.part_stride + g * w.F * d + f[:, None] * d + cc[None, :]
            welch_part[j][addr] = acc
            welch_hits[j][addr] += 1
    return (lag_part, lag_hits), (mom_part, mom_hits), list(zip(welch_part, welch_hits))


def reduce_section(part, batch, n_parts, count, part_stride, out_stride):
    """reduce_parts_kernel on one section: output e of batch * count is
    tenant e // count, entry e % count, the sum over q in order of its
    tenant's partials; returns (outputs, writes per output, reads in range)."""
    out = np.zeros((batch - 1) * out_stride + count, F32)  # strides are 0 at batch 1
    hits = np.zeros(out.shape, int)
    e = np.arange(batch * count)
    tn, i = e // count, e % count
    acc = np.zeros(e.shape, F32)
    reads = []
    for q in range(n_parts):
        idx = tn * part_stride + q * count + i
        reads.append(idx)
        acc = acc + part[idx].astype(F32)
    np.add.at(hits, tn * out_stride + i, 1)
    out[tn * out_stride + i] = acc
    reads = np.concatenate(reads)
    end = (batch - 1) * part_stride + n_parts * count
    return out, hits, bool((reads >= 0).all() and (reads < end).all())


def _fused_case(B=3, L=700, d=5, H=4, windows=(4, 9), seg=8, step=4, seed=0):
    reach = max(H, max(windows) - 1, seg - 1)
    y, mask, z0 = _operands(B, L, d, reach, seed)
    prep = fp.prepare_fused_plan(y, mask, z0, H, windows, (seg,), (step,), (_hann(seg),),
                                 sms=SMS)
    offs = fp.candidate_offsets(z0, L, prep.params.welch[0].n_entries
                                // prep.params.welch[0].n_cand,
                                prep.params.welch[0].tile, step, mask)
    return y, mask, z0, prep, offs.reshape(B, -1).numpy()


def test_megakernel_grid_folds_tenants_into_the_cta_index():
    y, mask, z0, prep, offs = _fused_case()
    p = prep.params
    per = tenant_ctas(p)
    assert p.batch == 3 and p.lag_slabs == 3 and p.mom_slabs == 3  # several slabs a tenant
    grid = roles(p, per)
    assert len(grid) == p.batch * per
    # tenant-major: each tenant's CTAs are one contiguous run of the same roles
    for tn in range(p.batch):
        run = grid[tn * per: (tn + 1) * per]
        assert {g[0] for g in run} == {tn}
        assert [g[1:] for g in run] == [g[1:] for g in grid[:per]]


def test_megakernel_walk_writes_every_partial_and_output_once_and_matches():
    y, mask, z0, prep, offs = _fused_case()
    p = prep.params
    (lag_part, lag_hits), (mom_part, mom_hits), welch = walk(p, y, mask, [offs], _hann)
    assert (lag_hits == 1).all() and (mom_hits == 1).all()
    assert all((hits == 1).all() for _, hits in welch)
    d, H, B = p.d, p.H, p.batch
    lag = lag_sums(p, lag_part, lag_direct(prep))
    mom, mom_out_hits, ok = reduce_section(mom_part, B, p.mom_slabs, p.K * 2 * d,
                                           p.mom_part_stride, p.mom_out_stride)
    assert ok and (mom_out_hits == 1).all()
    w = p.welch[0]
    psd, psd_hits, ok = reduce_section(welch[0][0], B, w.n_groups, w.F * d, w.part_stride,
                                       w.out_stride)
    assert ok and (psd_hits == 1).all()
    lag, mom, psd = (lag.reshape(B, H + 1, d, d), mom.reshape(B, p.K, 2, d),
                     psd.reshape(B, w.F, d))
    # against the plain batched version ...
    want = fpr.fused_plan_update_ref(y, mask, z0, H, (4, 9), (8,), (4,), (_hann(8),))
    np.testing.assert_allclose(lag, want[0].numpy(), **TOL)
    np.testing.assert_allclose(mom, want[1].numpy(), **TOL)
    np.testing.assert_allclose(psd, want[2][0].numpy(), **TOL)
    np.testing.assert_array_equal((offs >= 0).sum(1), want[3][0].numpy())
    # ... and the reference's, one tenant at a time
    jnp_be = JnpBackend()
    for tn in range(B):
        ref = jnp_be.fused_plan_update(jnp.asarray(y[tn].numpy()), jnp.asarray(mask[tn].numpy()),
                                       jnp.asarray(z0[tn].numpy()), H, (4, 9), (8,), (4,),
                                       (jnp.asarray(_hann(8).numpy()),))
        np.testing.assert_allclose(lag[tn], np.asarray(ref[0]), **TOL)
        np.testing.assert_allclose(mom[tn], np.asarray(ref[1]), **TOL)
        np.testing.assert_allclose(psd[tn], np.asarray(ref[2][0]), **TOL)


def test_reduction_order_is_fixed_and_batch_one_is_the_tenant_alone():
    """Each tenant's outputs are the same float32 bits whatever the order
    the CTAs ran in (they write disjoint partials) and equal the reduction
    of that tenant alone in a batch-1 launch."""
    rng = np.random.default_rng(5)
    B, n_parts, count = 4, 5, 37
    part = rng.standard_normal(B * n_parts * count).astype(F32) * 1e3
    out, _, _ = reduce_section(part, B, n_parts, count, n_parts * count, count)
    for tn in range(B):
        alone = part[tn * n_parts * count: (tn + 1) * n_parts * count]
        one, _, _ = reduce_section(alone, 1, n_parts, count, 0, 0)
        assert out[tn * count: (tn + 1) * count].tobytes() == one.tobytes()
    y, mask, z0, prep, offs = _fused_case(seed=2)
    p = prep.params
    first = walk(p, y, mask, [offs], _hann)[0][0]
    order = np.random.default_rng(0).permutation(len(roles(p, tenant_ctas(p))))
    grid = roles(p, tenant_ctas(p))
    shuffled = np.zeros_like(first)
    for k in order:  # the lag CTAs one at a time, in a shuffled order
        tn, role, r, _ = grid[k]
        if role == "lag":
            sub = _one_lag_cta(p, y, mask, tn, r)
            shuffled[sub[0]] = sub[1]
    assert shuffled.tobytes() == first.tobytes()


def _one_lag_cta(p, y, mask, tn, r):
    slab, h0, ng, i0, j0 = lag_cta(p, r)
    y64, m = y.numpy().astype(np.float64), mask.numpy()
    ts = np.arange(slab * p.lag_slab, min(slab * p.lag_slab + p.lag_slab, p.n))
    ts = ts[m[tn, ts]]
    ii, jj = (np.arange(i0, min(i0 + p.lag_tile, p.d)),
              np.arange(j0, min(j0 + p.lag_tile, p.d)))
    addrs, vals = [], []
    for h in range(h0, h0 + ng):
        addrs.append((tn * p.lag_part_stride + (slab * (p.H + 1) + h) * p.d * p.d
                      + ii[:, None] * p.d + jj[None, :]).ravel())
        vals.append((y64[tn, ts][:, ii].T @ y64[tn, ts + h][:, jj]).ravel())
    return np.concatenate(addrs), np.concatenate(vals)


def test_batch_one_is_the_one_problem_decomposition():
    """A (1, rows, d) launch fills the same grid as the (rows, d) launch:
    every field equal but the strides, which tenant 0 multiplies by 0."""
    y, mask, z0 = _operands(1, 700, 5, 8)
    args = (4, (4, 9), (8,), (4,), (_hann(8),))
    one = fp.prepare_fused_plan(y[0], mask[0], z0[0], *args, sms=SMS).params
    batched = fp.prepare_fused_plan(y, mask, z0, *args, sms=SMS).params
    strides = {"y_stride", "a_stride", "m_stride", "prefix_stride", "lag_part_stride",
               "lag_out_stride", "mom_part_stride", "mom_out_stride"}
    pointers = {"y", "a", "m", "prefix", "lag_part", "lag_out", "mom_part", "mom_out"}
    for name, _ in _build.PlanParams._fields_:
        if name in strides | pointers | {"welch"}:
            continue
        value = lambda x: list(x) if name == "windows" else x
        assert value(getattr(one, name)) == value(getattr(batched, name)), name
    for name, _ in _build.WelchMember._fields_:
        if name not in ("offs_stride", "part_stride", "out_stride", "cos", "sin", "taper",
                        "roots", "offs", "part", "out"):
            assert getattr(one.welch[0], name) == getattr(batched.welch[0], name), name
    assert one.batch == batched.batch == 1
    assert all(getattr(one, s) == 0 for s in strides)
    # kernels 2 and 3 alike
    a, b = torch.zeros((1, 300, 5)), torch.zeros((1, 304, 5))
    k2 = [ws.prepare_cross_lagged_sums(x, z, 4, sms=SMS).params for x, z in ((a[0], b[0]), (a, b))]
    assert (k2[0].lag_slabs, k2[0].lag_ctas) == (k2[1].lag_slabs, k2[1].lag_ctas)


def test_session_shape_launches_65536_tenants_on_one_grid():
    """The card's session: 65,536 tenants, d = 16, a 256-row chunk, lags to
    16, windows (32, 128), Welch 64/32.  One 1-D grid (no gridDim.y/z
    limit), one slab a tenant, and the offsets of tenant 65,535 computed in
    64 bits: at d = 64 the lag partials' offset passes 2^31."""
    B, L, d = 65536, 256, 16
    meta = torch.device("meta")
    y = torch.empty((B, L + 127, d), device=meta)
    mask = torch.empty((B, L), dtype=torch.bool, device=meta)
    z0 = torch.empty((B,), dtype=torch.int32, device=meta)
    prep = fp.prepare_fused_plan(y, mask, z0, 16, (32, 128), (64,), (32,), (_hann(64),),
                                 sms=SMS)
    p = prep.params
    assert p.lag_slabs == 1 and p.mom_slabs == 1 and p.batch == B
    # the tile sized by d: one lag CTA a tenant (17 lags in one run), which
    # writes the tenant's sums itself (no partials, no reduction of them)
    assert p.lag_tile == 16 and p.lag_groups == 1 and p.lag_ctas == 1
    assert lag_direct(prep) and prep.keep[2] is prep.out[0]
    grid = p.batch * tenant_ctas(p)
    assert 65535 < grid <= INT32_MAX
    assert (B - 1) * p.lag_part_stride + p.lag_part_stride == B * 17 * d * d
    wide = fp.prepare_fused_plan(torch.empty((B, L + 127, 64), device=meta), mask, z0, 16,
                                 (32, 128), (64,), (32,), (_hann(64),), sms=SMS).params
    assert (B - 1) * wide.lag_part_stride > INT32_MAX  # 32-bit offsets would wrap
    # every tenant offset in the roles and the reduction is taken in 64 bits:
    # the roles through at_tenant, the reduction on a 64-bit entry index
    src = (_build.KERNELS_DIR / "csrc" / "stats_tiles.cuh").read_text()
    uses = re.findall(r"at_tenant<BATCHED>\((?:p|w)\.(\w+), (?:p|w)\.(\w+)_stride, tn\)", src)
    assert {base for base, stride in uses if base == stride} == {
        "y", "a", "m", "prefix", "lag_part", "mom_part", "offs", "part"}
    assert "return BATCHED ? base + (long long)tn * stride : base;" in src
    assert "const long long tn = e / s.count;" in src
    assert "s.out[tn * s.out_stride + i] = acc;" in src


@pytest.mark.parametrize("max_lag", [0, 3])
def test_two_role_kernel_walk_serves_batched_kernel_3(max_lag):
    """Batched kernel 3 (B > 1) is the two-role kernel at every lag above
    0, and at H = 0 above MID_TILE channels (up to it, the batched path:
    tests/test_torch_lagmom_batched.py): walked and held against the plain
    batched version."""
    B, L, windows = 3, 300, (4, 9)
    d = 5 if max_lag else _build.MID_TILE + 1
    y, mask, _ = _operands(B, L, d, max(max_lag, max(windows) - 1), seed=4)
    prep = ws.prepare_fused_lag_moments(y, mask, max_lag, windows, sms=SMS)
    p = prep.params
    assert prep.entry is None and prep.path == "two_role" and p.batch == B
    (lag_part, lag_hits), (mom_part, mom_hits), _ = walk(p, y, mask, [])
    assert (lag_hits == 1).all() and (mom_hits == 1).all()
    assert p.lag_tile == TILE and not lag_direct(prep)  # kernel 3 keeps lag_role
    lag = lag_sums(p, lag_part, False)
    mom, _, _ = reduce_section(mom_part, B, p.mom_slabs, p.K * 2 * d, p.mom_part_stride,
                               p.mom_out_stride)
    want_lag, want_mom = wsr.fused_lag_moments_ref(y, mask, max_lag, windows)
    np.testing.assert_allclose(lag.reshape(want_lag.shape), want_lag.numpy(), **TOL)
    np.testing.assert_allclose(mom.reshape(want_mom.shape), want_mom.numpy(), **TOL)


@pytest.mark.parametrize("d,H", [(3, 8), (16, 16), (17, 40), (32, 2), (33, 16)])
def test_cross_lag_walk_serves_batched_kernel_2(d, H):
    """Batched kernel 2 (the lag tails of a batched finalize): the left
    factor is the mask-zeroed head, offset by its own stride (a_stride); at
    d <= 32 the tile sized by d, each tenant's sums written once by its one
    lag CTA of one slab, or summed from its slabs' partials."""
    B, L = 4, 127
    y, mask, _ = _operands(B, L, d, H, seed=6)
    head = torch.where(mask[..., None], y[:, :L], 0.0).contiguous()
    prep = ws.prepare_cross_lagged_sums(head, y, H, sms=SMS)
    p = prep.params
    assert p.a_stride == L * d and p.y_stride == (L + H) * d and p.lag_slabs == 1
    assert p.lag_tile == (16 if d <= 16 else 32 if d <= 32 else TILE)
    assert lag_direct(prep) == (d <= 32)
    (lag_part, hits), _, _ = walk(p, y, mask, [], a=head)
    assert (hits == 1).all()
    lag = lag_sums(p, lag_part, lag_direct(prep)).reshape(B, H + 1, d, d)
    np.testing.assert_allclose(lag, ws.masked_lagged_sums(y, mask, H).numpy(), **TOL)
    for tn in range(B):
        want = JnpBackend().masked_lagged_sums(jnp.asarray(y[tn].numpy()),
                                               jnp.asarray(mask[tn].numpy()), H)
        np.testing.assert_allclose(lag[tn], np.asarray(want), **TOL)
    # the reference's cross-lag kernel (Pallas, interpret mode) on one tenant
    cross = ref_ws.cross_lagged_sums(jnp.asarray(head[1].numpy()), jnp.asarray(y[1].numpy()), H,
                                     block_t=64, interpret=True)
    np.testing.assert_allclose(lag[1], np.asarray(cross), **TOL)


@pytest.mark.parametrize("d,H,L,sms", [(5, 4, 203, SMS), (16, 16, 203, SMS),
                                       (16, 40, 203, SMS), (29, 17, 203, SMS),
                                       (16, 16, 700, 4096)])
def test_small_width_megakernel_walk_writes_each_lag_output_once(d, H, L, sms):
    """Kernel 1 at d <= 32: the one lag tile sized by d, runs of at most
    SMALL_LAGS lags, every (tenant, lag, i, j) output written exactly once
    (directly at one slab a tenant; through the partials and the reduction
    with several, here by more SMs than the batch fills), against the plain
    version and the reference per tenant."""
    B, windows = 3, (4, 9)
    reach = max(H, max(windows) - 1, 7)
    y, mask, z0 = _operands(B, L, d, reach, seed=d + H)
    prep = fp.prepare_fused_plan(y, mask, z0, H, windows, (8,), (4,), (_hann(8),), sms=sms)
    p = prep.params
    assert p.lag_tile == (16 if d <= 16 else 32)
    assert p.lag_groups == -(-(H + 1) // _build.SMALL_LAGS)
    assert p.lag_ctas == p.lag_slabs * p.lag_groups
    assert lag_direct(prep) == (p.lag_slabs == 1) and (sms != SMS) == (p.lag_slabs > 1)
    offs = fp.candidate_offsets(z0, L, p.welch[0].n_entries // p.welch[0].n_cand,
                                p.welch[0].tile, 4, mask).reshape(B, -1).numpy()
    (lag_part, hits), _, _ = walk(p, y, mask, [offs], _hann)
    assert (hits == 1).all()
    lag = lag_sums(p, lag_part, lag_direct(prep)).reshape(B, H + 1, d, d)
    want = fpr.fused_plan_update_ref(y, mask, z0, H, windows, (8,), (4,), (_hann(8),))[0]
    np.testing.assert_allclose(lag, want.numpy(), **TOL)
    for tn in range(B):
        ref = JnpBackend().masked_lagged_sums(jnp.asarray(y[tn].numpy()),
                                              jnp.asarray(mask[tn].numpy()), H)
        np.testing.assert_allclose(lag[tn], np.asarray(ref), **TOL)


def test_small_role_constants_mirror_the_source():
    """The small-width role's #defines equal _build.py's mirrors, in the
    order rt_stats_constants writes them (the library checks them at load)."""
    src = (_build.KERNELS_DIR / "csrc" / "stats_tiles.cuh").read_text()
    defines = dict(re.findall(r"^#define (RT_\w+) (\d+)", src, re.M))
    for name, macro in _build.STATS_CONSTANTS.items():
        if macro in defines:
            assert int(defines[macro]) == getattr(_build, name), name
    assert {"RT_SMALL_TILE", "RT_MID_TILE", "RT_SMALL_LAGS"} <= set(defines)
    entry = (_build.KERNELS_DIR / "fused_plan" / "csrc" / "fused_plan.cu").read_text()
    listed = re.search(r"const int c\[\] = \{([^}]*)\}", entry).group(1)
    assert [m.strip() for m in listed.split(",")] == list(_build.STATS_CONSTANTS.values())


def test_session_ablations_wrap_each_role_call_once():
    """variants_bench.py's role split of kernel 1 compiles each role out of a
    copy of fused_plan.cu: each role's call in fused_plan_kernel is found
    once and wrapped in its #ifndef."""
    import importlib.util

    path = _build.REPO_ROOT / "tools" / "kernel_variants" / "variants_bench.py"
    spec = importlib.util.spec_from_file_location("variants_bench", path)
    vb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vb)
    src = (_build.KERNELS_DIR / "fused_plan" / "csrc" / "fused_plan.cu").read_text()
    text = vb.session_ablation_source(src)
    for flag in ("NO_LAG", "NO_MOM", "NO_WELCH"):
        assert text.count(f"#ifndef ABL_{flag}\n") == 1
    assert "#ifndef ABL_NO_LAG\n    lag_tile_role<TW, BATCHED>(p, b, tn, smem);\n#endif\n" in text
    assert {f for flags in vb.SESSION_ABLATIONS.values() for f in flags} == {
        "NO_LAG", "NO_MOM", "NO_WELCH"}
