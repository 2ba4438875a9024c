"""Numpy models of kernel 7's index arithmetic: the banded product (with its
transposed-band flag) and the gradient of its diagonals.

The CUDA kernels of ``banded_matvec/csrc/banded_matvec.cu`` run only on the
card; this file walks their grids here, on the launch shapes the wrappers
compute (``ops.forward_shape`` / ``ops.gradient_shape``) and the tile
constants that ``_build.py`` mirrors from the source: the column tiles of
4-column threads, the float4 halo at both edges, the staged diagonals (with
the halo rows of A^T, read as diags[r+o, b-o]), the row slabs, each slab's
sums left in shared memory and summed over the cluster in rank order, and
the generic paths.  Each walk checks that every output is written exactly
once and that every staged or shared-memory index it reads lies in what was
staged, then is held against the plain versions (``ref.py``) and against the
reference's VJP (``jax.vjp`` of the Pallas kernel in interpret mode), each
entry within 1e-5 of its own scale: sum_o |a||x| for a product, sum_n
|g||x| for a gradient.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.banded_matvec import ops as jbm
from repro_torch.kernels import _build
from repro_torch.kernels.banded_matvec import ops as bm, ref as bmr

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

SMS = 132  # the H100's SMs: the wrappers size their grids by them
TOL = 1e-5
F32 = np.float32


def _rand(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(F32)


def _window(x_row, c, d, hq):
    """The vector paths' float4 window of one row: columns c - 4 HQ .. c + 3
    + 4 HQ for every thread (c: the threads' first columns), 0 off the
    matrix; a float4 lies wholly on or off it."""
    win = np.zeros((4 + 8 * hq, len(c)), F32)
    for q in range(-hq, hq + 1):
        col = c + 4 * q
        on = (col >= 0) & (col < len(x_row))
        assert np.array_equal(on, (col + 3 >= 0) & (col + 3 < d))
        for j in range(4):
            win[4 * hq + 4 * q + j] = np.where(on, x_row[np.clip(col + j, 0, d - 1)], 0)
    return win


def _row_coefficients(flat, w, b, h, c, H):
    """banded_matvec_row<b>'s coefficients: each thread reads rows c .. c + 3
    of diags as w float4 from a 16-byte boundary, [o + H, k] as in the
    CTA-staged kernel."""
    assert (c * w % 4 == 0).all()
    run = flat[(c * w)[:, None] + np.arange(4 * w)[None, :]]
    out = np.zeros((2 * H + 1, 4, len(c)), F32)
    for o in range(-h, h + 1):
        for k in range(4):
            out[o + H, k] = run[:, k * w + b + o]
    return out


def walk_forward(diags, x, transposed, s):
    """banded_matvec_vec4<HQ, T> or banded_matvec_kernel on the grid ``s``;
    returns y and how often each entry was written."""
    d, w = diags.shape
    b, m, h = (w - 1) // 2, x.shape[0], s["halo"]
    flat = diags.reshape(-1)
    y = np.full((m, d), np.nan, F32)
    writes = np.zeros((m, d), int)
    for blk in range(s["col_tiles"] * s["row_slabs"]):
        tile, slab = blk % s["col_tiles"], blk // s["col_tiles"]
        n0 = slab * s["rows_per_cta"]
        n1 = min(n0 + s["rows_per_cta"], m)
        if s["vec"]:
            hq, cols = s["vec"], 4 * s["threads"]
            H = 4 * hq
            c0 = tile * cols
            # rows r0 .. of diags (A^T: H more a side), as float4 from a
            # 16-byte boundary, each wholly on or off the matrix (0 off it)
            r0 = c0 - H if transposed else c0
            rows = cols + 2 * H if transposed else min(cols, d - c0)
            assert r0 * w % 4 == 0 and rows * w % 4 == 0 and flat.size % 4 == 0
            cs = np.full((cols + (2 * H if transposed else 0)) * w, np.nan, F32)
            one_row = s["rows_per_cta"] == 1 and not transposed  # banded_matvec_row<b>
            assert s["smem_bytes"] == (0 if one_row else 4 * cs.size)
            for i in range(rows * w // 4):
                f = r0 * w // 4 + i
                cs[4 * i: 4 * i + 4] = flat[4 * f: 4 * f + 4] if 0 <= f < flat.size // 4 else 0
            t4 = 4 * np.arange(s["threads"])
            t4 = t4[c0 + t4 < d]
            c = c0 + t4
            a = np.zeros((2 * H + 1, 4, len(c)), F32)
            for o in range(-h, h + 1):
                for k in range(4):
                    i = ((t4 + k + o + H) * w + b - o) if transposed else ((t4 + k) * w + b + o)
                    assert i.min() >= 0 and i.max() < cs.size
                    a[o + H, k] = cs[i]
            assert not np.isnan(a).any()  # every coefficient read was staged
            if one_row:
                assert np.array_equal(a, _row_coefficients(flat, w, b, h, c, H))
            for n in range(n0, n1):
                win = _window(x[n], c, d, hq)
                for k in range(4):
                    acc = np.zeros(len(c), F32)
                    for o in range(-h, h + 1):
                        acc = acc + a[o + H, k] * win[H + k + o]
                    y[n, c + k] = acc
                    writes[n, c + k] += 1
        else:
            width, rpp = _build.BAND_COLS + 2 * h, s["rows_per_pass"]
            assert s["smem_bytes"] == 4 * width * rpp
            c0 = tile * _build.BAND_COLS
            t = np.arange(_build.BAND_COLS)
            t = t[c0 + t < d]
            r = c0 + t
            cols_ = c0 - h + np.arange(width)
            on = (cols_ >= 0) & (cols_ < d)
            for n in range(n0, n1, rpp):
                rows = min(rpp, n1 - n)
                xs = np.where(on, x[n: n + rows, np.clip(cols_, 0, d - 1)], 0).astype(F32)
                acc = np.zeros((rows, len(r)), F32)
                for o in range(-h, h + 1):
                    if transposed:
                        rr = r + o
                        a = np.where((rr >= 0) & (rr < d), diags[np.clip(rr, 0, d - 1), b - o], 0)
                    else:
                        a = diags[r, b + o]
                    acc = acc + a.astype(F32) * xs[:, t + h + o]
                y[n: n + rows, r] = acc
                writes[n: n + rows, r] += 1
    return y, writes


def walk_gradient(g, x, b, s):
    """band_gradient_vec4<HQ> or band_gradient_kernel on the grid ``s``;
    returns d diags (d, 2b+1) and how often each entry was written."""
    m, d = x.shape
    w, h = 2 * b + 1, s["halo"]
    out = np.full(d * w, np.nan, F32)
    writes = np.zeros(d * w, int)
    if s["vec"]:
        hq, cols, slabs = s["vec"], 4 * s["threads"], s["row_slabs"]
        H = 4 * hq
        assert slabs & (slabs - 1) == 0 and slabs <= _build.BAND_MAX_SLABS
        assert s["smem_bytes"] == 4 * w * cols
        for tile in range(s["col_tiles"]):
            c0 = tile * cols
            t4 = 4 * np.arange(s["threads"])
            t4 = t4[c0 + t4 < d]
            c = c0 + t4
            parts = []
            for rank in range(slabs):
                n0 = rank * s["rows_per_cta"]
                n1 = min(n0 + s["rows_per_cta"], m)
                acc = np.zeros((4, 2 * H + 1, len(c)), F32)
                for n in range(n0, n1):
                    win = _window(x[n], c, d, hq)
                    for k in range(4):
                        for o in range(-h, h + 1):
                            acc[k, o + H] = acc[k, o + H] + g[n, c + k] * win[H + k + o]
                part = np.full(cols * w, np.nan, F32)  # shared memory, never zeroed
                for k in range(4):
                    for slot in range(w):
                        part[(t4 + k) * w + slot] = 0
                    for o in range(-h, h + 1):
                        part[(t4 + k) * w + b + o] = acc[k, o + H]
                parts.append(part)
            total = min(cols, d - c0) * w
            share = -(-total // slabs)
            for rank in range(slabs):  # CTA `rank` reduces its share, in rank order
                e = np.arange(rank * share, min(rank * share + share, total))
                v = np.zeros(len(e), F32)
                for q in range(slabs):
                    v = v + parts[q][e]
                out[c0 * w + e] = v
                writes[c0 * w + e] += 1
    else:
        assert s["row_slabs"] == 1 and s["rows_per_cta"] == m
        for tile in range(s["col_tiles"]):
            r = tile * _build.BAND_COLS + np.arange(_build.BAND_COLS)
            r = r[r < d]
            for chunk in range(s["offset_chunks"]):
                o0 = -b + chunk * _build.BAND_OFFSETS
                offs = [o for o in range(o0, o0 + _build.BAND_OFFSETS) if o <= b]
                acc = np.zeros((len(offs), len(r)), F32)
                for n in range(m):
                    for i, o in enumerate(offs):
                        col = r + o
                        on = (col >= 0) & (col < d)
                        acc[i] = np.where(on, acc[i] + g[n, r] * x[n, np.clip(col, 0, d - 1)],
                                          acc[i])
                for i, o in enumerate(offs):
                    out[r * w + b + o] = acc[i]
                    writes[r * w + b + o] += 1
    return out.reshape(d, w), writes.reshape(d, w)


def _held(got, want, scale):
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert np.isfinite(got).all()
    assert (diff <= TOL * scale + 1e-30).all(), float((diff / np.maximum(scale, 1e-30)).max())


SHAPES = [(d, b, m) for d in (5, 300, 1000, 4099) for b in (0, 1, 4, 6) for m in (1, 7, 33)]


@pytest.mark.parametrize("d,b,m", SHAPES)
def test_walks_match_the_plain_versions(d, b, m):
    """Both products and the gradient, on the grids the wrappers launch:
    every output written once, within 1e-5 of its scale; A^T through the
    flag bitwise equal to the product on band_transpose(diags); off-matrix
    slots of the diagonals hold random values."""
    diags, x, g = _rand(d, 2 * b + 1, seed=d + b), _rand(m, d, seed=m), _rand(m, d, seed=m + 1)
    tdiags, tx, tg = (torch.from_numpy(a) for a in (diags, x, g))
    fwd = bm.forward_shape(m, d, b, True, False, SMS)
    y, writes = walk_forward(diags, x, False, fwd)
    assert (writes == 1).all()
    _held(y, bmr.banded_matvec_ref(tdiags, tx).numpy(),
          bmr.banded_matvec_ref(tdiags.abs(), tx.abs()).numpy())
    yt, writes = walk_forward(diags, g, True, bm.forward_shape(m, d, b, True, True, SMS))
    assert (writes == 1).all()
    tband = bmr.band_transpose(tdiags)
    assert np.array_equal(yt, walk_forward(tband.numpy(), g, False, fwd)[0])
    _held(yt, bmr.banded_matvec_ref(tband, tg).numpy(),
          bmr.banded_matvec_ref(tband.abs(), tg.abs()).numpy())
    dd, writes = walk_gradient(g, x, b, bm.gradient_shape(m, d, b, True, SMS))
    assert (writes == 1).all()
    _held(dd, bmr.band_gradient(tg, tx, b).numpy(),
          bmr.band_gradient(tg.abs(), tx.abs(), b).numpy())


@pytest.mark.parametrize("d,b", [(d, b) for d in (5, 300, 1000, 4099) for b in (0, 1, 4, 6)])
def test_walks_match_the_reference_vjp(d, b):
    """y, d diags and d x of the reference's custom VJP (Pallas kernel in
    interpret mode; x and g (d, m) there, (m, d) here) against the walks."""
    m = (1, 7, 33)[(d + b) % 3]
    diags, x, g = _rand(d, 2 * b + 1, seed=d), _rand(m, d, seed=b), _rand(m, d, seed=b + 1)
    y, vjp = jax.vjp(lambda a, xx: jbm.banded_matvec(a, xx, interpret=True),
                     jnp.asarray(diags), jnp.asarray(x.T))
    ddiags, dx = (np.asarray(t) for t in vjp(jnp.asarray(g.T)))
    tdiags, tx, tg = (torch.from_numpy(a) for a in (diags, x, g))
    valid = bmr.band_transpose(bmr.band_transpose(torch.ones_like(tdiags))).numpy()
    _held(walk_forward(diags, x, False, bm.forward_shape(m, d, b, True, False, SMS))[0],
          np.asarray(y).T, bmr.banded_matvec_ref(tdiags.abs(), tx.abs()).numpy())
    _held(walk_forward(diags, g, True, bm.forward_shape(m, d, b, True, True, SMS))[0], dx.T,
          bmr.banded_matvec_ref(bmr.band_transpose(tdiags).abs(), tg.abs()).numpy())
    # the reference's off-matrix slots of d diags are 0, as the walk's
    _held(walk_gradient(g, x, b, bm.gradient_shape(m, d, b, True, SMS))[0] * valid, ddiags,
          bmr.band_gradient(tg.abs(), tx.abs(), b).numpy())


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("d,b", [(5, 4), (1000, 3), (4, 2)])
def test_unaligned_inputs_take_the_generic_paths(d, b, transposed):
    """Rows off a 16-byte boundary (or d % 4 != 0, or b > 8) go to the
    generic paths, never to the vector ones, and those walks still match."""
    assert bm.forward_shape(3, d, b, False, transposed, SMS)["vec"] == 0
    assert bm.gradient_shape(3, d, b, False, SMS)["vec"] == 0
    assert bm.forward_shape(3, 4096, 9, True, transposed, SMS)["vec"] == 0
    diags, x = _rand(d, 2 * b + 1, seed=1), _rand(3, d, seed=2)
    s = bm.forward_shape(3, d, b, False, transposed, SMS)
    y, writes = walk_forward(diags, x, transposed, s)
    assert (writes == 1).all()
    band = bmr.band_transpose(torch.from_numpy(diags)) if transposed else torch.from_numpy(diags)
    _held(y, bmr.banded_matvec_ref(band, torch.from_numpy(x)).numpy(),
          bmr.banded_matvec_ref(band.abs(), torch.from_numpy(x).abs()).numpy())


@pytest.mark.parametrize("m,d,b", [(2047, 131072, 4), (1, 131072, 4), (2047, 4096, 8),
                                   (3, 1024, 1), (2047, 1000, 3)])
def test_grids_cover_every_row_and_column_once(m, d, b):
    """At the spatial fit's shapes and a few others: the slabs tile the rows
    [0, m) without a gap or an overlap, the column tiles cover [0, d); the
    gradient's grid is a whole number of clusters of a power of two of CTAs
    (at most the portable 8), its shared memory within one CTA's limit."""
    for transposed in (False, True):
        s = bm.forward_shape(m, d, b, True, transposed, SMS)
        assert (s["row_slabs"] - 1) * s["rows_per_cta"] < m <= s["row_slabs"] * s["rows_per_cta"]
        cols = 4 * s["threads"] if s["vec"] else _build.BAND_COLS
        assert (s["col_tiles"] - 1) * cols < d <= s["col_tiles"] * cols
        assert s["threads"] <= 256 and s["smem_bytes"] <= 232448
        if m == 1:
            assert s["threads"] == bm.ONE_ROW_THREADS and s["row_slabs"] == 1
    s = bm.gradient_shape(m, d, b, True, SMS)
    slabs = s["row_slabs"]
    assert slabs & (slabs - 1) == 0 and slabs <= min(m, _build.BAND_MAX_SLABS)
    assert (slabs - 1) * s["rows_per_cta"] < m <= slabs * s["rows_per_cta"]
    cols = 4 * s["threads"]
    assert (s["col_tiles"] - 1) * cols < d <= s["col_tiles"] * cols
    assert s["smem_bytes"] == 4 * (2 * b + 1) * cols <= 232448
    if (m, d) == (2047, 131072):  # the fit: one cluster of 8 slabs per column tile
        assert slabs == 8 and s["col_tiles"] * slabs >= SMS


def test_python_constants_match_the_c_defines():
    """_build.BAND_CONSTANTS against banded_matvec.cu's #defines, and
    rt_band_constants writes them in the mirror's order."""
    cu = (_build.KERNELS_DIR / "banded_matvec" / "csrc" / "banded_matvec.cu").read_text()
    defines = dict(re.findall(r"^#define (B[MG]_\w+) (\d+)\b", cu, re.M))
    assert ({name: int(defines[macro]) for name, macro in _build.BAND_CONSTANTS.items()}
            == {name: getattr(_build, name) for name in _build.BAND_CONSTANTS})
    body = cu[cu.index("void rt_band_constants"):]
    assert (re.findall(r"B[MG]_\w+", body[body.index("{"): body.index("};")])
            == list(_build.BAND_CONSTANTS.values()))


def test_variant_points_apply_to_their_sources():
    """Every design point that ``variants_bench.py banded`` times patches
    #defines that its source holds once (banded_matvec.cu, or the ring
    variant beside the bench), and each launch-shape constant it sets is one
    of ``ops``'; the first point of each kernel is the shipped design."""
    import importlib.util

    path = _build.REPO_ROOT / "tools" / "kernel_variants" / "variants_bench.py"
    spec = importlib.util.spec_from_file_location("variants_bench", path)
    vb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vb)
    shipped = (_build.KERNELS_DIR / "banded_matvec" / "csrc" / "banded_matvec.cu").read_text()
    firsts = {}
    for kernel, defines, knobs in vb.BAND_POINTS:
        firsts.setdefault(kernel, (defines, knobs))
        defines = dict(defines)
        text = (path.parent / defines.pop("SOURCE")).read_text() if "SOURCE" in defines \
            else shipped
        patched = vb._define_source(text, defines)
        for name, value in defines.items():
            assert re.findall(rf"^#define {name} (\d+)", patched, re.M) == [str(value)]
        assert all(hasattr(bm, k) for k in knobs)
    assert set(firsts) == {"band_gradient", "banded_matvec", "banded_matvec_nrhs_1"}
    assert all(first == ({}, {}) for first in firsts.values())
