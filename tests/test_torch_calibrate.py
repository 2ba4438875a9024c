"""The port's calibration layer (`repro_torch.core.calibrate`) and its
"auto" backend, against `repro.core.calibrate`.

Ports tests/test_calibrate.py on the CPU, where both of the port's
backends run the plain versions: the built-in tables (``inf`` on the CPU,
0 on "cuda", nothing carried over from the TPU), the cache round trip and
its hygiene (another platform, another card, a corrupt file), measured and
injected tables steering "auto", tuned blocks steering
`repro_torch.kernels.tiling.resolve_block`, and the command line.  Then the
port against the reference: a table the reference wrote is read, the same
thresholds route every primitive alike at sizes below, at and above them
(the port's "cuda" where the reference's "pallas", outputs within
tests/test_backend.py's tolerances), a batch of 37 problems is sized as one
problem, and the command line imports neither JAX nor `repro`.
"""
import json
import math
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibrate as jcal
from repro.core.backend import AutoBackend as RefAutoBackend
from repro.core.backend import PallasBackend
from repro_torch.core import calibrate as cal
from repro_torch.core.backend import (AutoBackend, CudaBackend, TorchBackend, get_backend,
                                      list_backends, set_default_backend)

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _isolate(tmp_path, monkeypatch):
    """Every test gets its own cache file; installed tables are reset."""
    monkeypatch.setenv("REPRO_TORCH_CALIB_CACHE", str(tmp_path / "calib.json"))
    monkeypatch.delenv("REPRO_TORCH_AUTO_CALIBRATE", raising=False)
    yield
    cal.set_active_table(None)


def _table(thresholds, platform="cpu", source="test", device=None):
    return cal.CalibrationTable(platform, dict(thresholds), source, device=device)


class _Recording(CudaBackend):
    """The "cuda" backend, counting which primitives reach it."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __getattribute__(self, name):
        attr = object.__getattribute__(self, name)
        if name in cal.PRIMITIVES:
            calls = object.__getattribute__(self, "calls")

            def wrapped(*args, **kwargs):
                calls.append(name)
                return attr(*args, **kwargs)

            return wrapped
        return attr


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _drive_all_primitives(be):
    """One small call per registered primitive through ``be``."""
    rng = np.random.RandomState(0)
    x, y = _t(rng.randn(48, 2)), _t(rng.randn(52, 2))
    mask = torch.ones(48, dtype=torch.bool)
    segs = _t(rng.randn(3, 16, 2))
    taper = _t(np.hanning(16))
    diags = _t(rng.randn(48, 5))
    be.lagged_sums(x, 4)
    be.masked_lagged_sums(y, mask, 4)
    be.windowed_moments(x, 8)
    be.segment_fft_power(segs, taper)
    be.segment_csd(segs, taper)
    be.banded_matvec(diags, x[:, 0])
    be.fused_lagged_moments(y, mask, 4, 8)
    be.fused_plan_update(y, mask, 0, 4, (8,), (16,), (8,), (taper,))


# --------------------------------------- ports of tests/test_calibrate.py
def test_default_tables_cpu_never_cuda_always_nothing_from_the_tpu():
    table = cal.default_table("cpu")
    assert set(table.thresholds) == set(cal.PRIMITIVES)
    assert all(math.isinf(v) for v in table.thresholds.values())
    # before any measurement "auto" on the card behaves as the default "cuda"
    card = cal.default_table("cuda")
    assert set(card.thresholds) == set(cal.PRIMITIVES)
    assert all(v == 0.0 for v in card.thresholds.values())
    # no TPU crossover is carried over
    assert all(math.isinf(v) for v in cal.default_table("tpu").thresholds.values())
    assert cal.default_table().platform == "cpu" and cal.default_table().device is None


def test_auto_dispatch_follows_injected_table():
    rec = _Recording()
    auto = AutoBackend(cuda_backend=rec, table=_table({p: 0.0 for p in cal.PRIMITIVES}))
    _drive_all_primitives(auto)
    assert sorted(set(rec.calls)) == sorted(cal.PRIMITIVES)
    assert {r for _, r, _ in auto.routes} == {"cuda"}
    rec2 = _Recording()
    auto2 = AutoBackend(cuda_backend=rec2,
                        table=_table({p: math.inf for p in cal.PRIMITIVES}))
    _drive_all_primitives(auto2)
    assert rec2.calls == []
    assert sum(auto2.routes.values()) == len(cal.PRIMITIVES)
    assert {r for _, r, _ in auto2.routes} == {"torch"}


def test_auto_per_primitive_thresholds_are_independent():
    rec = _Recording()
    thresholds = {p: math.inf for p in cal.PRIMITIVES}
    thresholds["lagged_sums"] = 10.0  # only this one crosses over
    auto = AutoBackend(cuda_backend=rec, table=_table(thresholds))
    _drive_all_primitives(auto)
    assert set(rec.calls) == {"lagged_sums"}
    x = _t(np.random.RandomState(4).randn(64, 2))
    np.testing.assert_allclose(auto.lagged_sums(x, 3), TorchBackend().lagged_sums(x, 3),
                               atol=1e-4)


def test_cache_roundtrip_and_platform_hygiene():
    table = _table({p: (512.0 if i % 2 else math.inf) for i, p in enumerate(cal.PRIMITIVES)},
                   source="measured")
    cal.save_table(table)
    loaded = cal.load_table()
    assert loaded is not None and loaded.source == "cache"
    assert loaded.thresholds == table.thresholds  # inf survives JSON (null)
    assert cal.resolve_table().thresholds == table.thresholds
    # a cache written on another platform is ignored, never misapplied
    cal.save_table(_table({p: 1.0 for p in cal.PRIMITIVES}, platform="tpu"))
    assert cal.load_table() is None
    assert cal.resolve_table(autocalibrate=False).source == "default"


def test_calibrate_measures_all_primitives_and_persists(tmp_path):
    path = tmp_path / "calib.json"
    table = cal.calibrate(sizes=(16, 64), d=2, iters=1, warmup=0, save=True)
    assert table.source == "measured" and table.platform == "cpu"
    assert set(table.thresholds) == set(cal.PRIMITIVES)
    for v in table.thresholds.values():
        # 0 where "cuda" won at both sizes, 64 where only at the larger
        assert math.isinf(v) or v in (0.0, 64.0)
    # the medians of both backends at every size, for every primitive
    for prim in cal.PRIMITIVES:
        for n in (16, 64):
            m = table.timings["crossover"][prim][n]
            assert set(m) == {"torch", "cuda"} and all(t > 0 for t in m.values())
    assert path.exists()
    assert cal.resolve_table().thresholds == table.thresholds


def test_registry_auto_has_no_hardcoded_row_constant():
    auto = get_backend("auto", device="cpu")
    assert isinstance(auto, AutoBackend) and not hasattr(auto, "min_rows")
    assert set(auto.table.thresholds) == set(cal.PRIMITIVES)
    assert set(list_backends()) == {"auto", "cuda", "torch"}
    # the default stays "cuda": "auto" is opt-in
    assert get_backend(None, device="cpu").name == "cuda"
    set_default_backend("auto")
    try:
        assert get_backend(None, device="cpu") is auto
    finally:
        set_default_backend("cuda")
    with pytest.raises(KeyError):
        set_default_backend("pallas")


def test_stale_cache_missing_primitive_falls_back_to_builtin():
    old = {p: 0.0 for p in cal.PRIMITIVES if p != "fused_plan_update"}
    assert math.isinf(_table(old).crossover("fused_plan_update"))
    assert _table(old, platform="cuda").crossover("fused_plan_update") == 0.0
    rec = _Recording()
    auto = AutoBackend(cuda_backend=rec, table=_table(old))
    _drive_all_primitives(auto)
    assert "fused_plan_update" not in rec.calls
    assert "lagged_sums" in rec.calls


def test_blocks_json_roundtrip_and_resolution():
    from repro_torch.kernels.tiling import DEFAULT_BLOCKS, resolve_block

    table = _table({p: math.inf for p in cal.PRIMITIVES}, source="measured")
    table.blocks = {"fused_plan_update": {"block_t": 256}}
    cal.save_table(table)
    loaded = cal.load_table()
    assert loaded.blocks == table.blocks
    assert loaded.block_config("fused_plan_update") == {"block_t": 256}
    assert loaded.block_config("banded_matvec") == {}
    # a table on disk steers no kernel until it is installed
    assert resolve_block("fused_plan_update", "block_t") == \
        DEFAULT_BLOCKS["fused_plan_update"]["block_t"]
    assert cal.active_blocks("fused_plan_update") == {}
    cal.set_active_table(cal.default_table())
    assert resolve_block("fused_plan_update", "block_t") == \
        DEFAULT_BLOCKS["fused_plan_update"]["block_t"]
    cal.set_active_table(loaded)
    assert cal.active_blocks("fused_plan_update") == {"block_t": 256}
    assert resolve_block("fused_plan_update", "block_t", None) == 256
    assert resolve_block("fused_plan_update", "block_t", 64) == 64  # override first
    assert resolve_block("banded_matvec", "block_rows", None) == \
        DEFAULT_BLOCKS["banded_matvec"]["block_rows"]
    cal.set_active_table(None)
    assert cal.active_blocks("fused_plan_update") == {}
    # resolve_table installs the cached table: from then on it steers
    assert cal.resolve_table(autocalibrate=False).blocks == table.blocks
    assert resolve_block("fused_plan_update", "block_t") == 256


def test_tuned_block_steers_the_megakernel_launch():
    """The table's block_t reaches kernel 1's Welch candidate tables (the
    launch filled on the CPU without launching): tiles of the tuned size."""
    from repro_torch.kernels.fused_plan import ops as fp

    y, mask = torch.zeros(1100, 4), torch.ones(1000, dtype=torch.bool)
    taper = torch.hann_window(64, periodic=False)

    def welch_tile():
        prep = fp.prepare_fused_plan(y, mask, 0, 4, (8,), (64,), (32,), (taper,), sms=132)
        m = prep.params.welch[0]
        return m.tile, m.n_entries

    table = _table({}, source="measured")
    cal.set_active_table(table)
    table.blocks = {"fused_plan_update": {"block_t": 128}}
    # 1,000 rows: 8 tiles of 128 with 5 candidates each, or 2 of 512 with 17
    assert welch_tile() == (128, 8 * 5)
    table.blocks = {"fused_plan_update": {"block_t": 512}}
    assert welch_tile() == (512, 2 * 17)


def test_tune_blocks_records_only_the_knobs_the_kernels_read(monkeypatch):
    from repro_torch.kernels.tiling import DEFAULT_BLOCKS

    monkeypatch.setattr(cal, "BLOCK_CANDIDATES", {"block_t": (32, 64)})
    table = cal.tune_blocks(n=48, iters=1, warmup=0, save=True)
    tunable = {p for p, params in cal.TUNABLE_BLOCKS.items() if params}
    assert tunable == {"fused_plan_update"}
    assert set(table.blocks) <= tunable
    assert table.blocks.get("fused_plan_update", {}).get("block_t", 32) in (32, 64)
    # every candidate and the built-in block are timed
    default = DEFAULT_BLOCKS["fused_plan_update"]["block_t"]
    assert set(table.timings["blocks"]["fused_plan_update"]["block_t"]) == {32, 64, default}
    assert cal.load_table().blocks == table.blocks
    assert cal.active_table() is table


def test_tune_blocks_drops_a_candidate_outside_tolerance(monkeypatch, capsys):
    """A candidate whose outputs leave the plain version's tolerance is
    printed and never recorded."""
    monkeypatch.setattr(cal, "BLOCK_CANDIDATES", {"block_t": (32, 64)})

    class Broken(CudaBackend):
        def fused_plan_update(self, *args, **kwargs):
            lag, mom, psds, n_segs = super().fused_plan_update(*args, **kwargs)
            return (lag * 1.01 if self.block_t == 32 else lag), mom, psds, n_segs

    monkeypatch.setattr("repro_torch.core.backend.CudaBackend", Broken)
    # were it timed, 32 would win by far
    monkeypatch.setattr(cal, "_fastest_beyond_spread", lambda samples, default: min(samples))
    table = cal.tune_blocks(n=48, iters=1, warmup=0, save=False)
    assert table.blocks["fused_plan_update"] == {"block_t": 64}
    assert table.timings["blocks"]["fused_plan_update"]["block_t"][32] == "dropped"
    assert "block_t=32" in capsys.readouterr().out


def test_calibrate_tune_blocks_one_artifact(monkeypatch):
    monkeypatch.setattr(cal, "BLOCK_CANDIDATES", {"block_t": (32,)})
    monkeypatch.setattr(cal, "_fastest_beyond_spread", lambda samples, default: 32)
    table = cal.calibrate(sizes=(32,), d=2, iters=1, warmup=0, save=True, tune_blocks=True)
    assert set(table.thresholds) == set(cal.PRIMITIVES)
    assert table.blocks == {"fused_plan_update": {"block_t": 32}}
    assert cal.load_table().blocks == table.blocks


@pytest.mark.parametrize("wins, want", [
    ((True, True, True), 0.0),       # "cuda" won everywhere: no size below the grid guessed
    ((False, True, True), 64.0),
    ((True, False, True), 256.0),    # a loss in the middle: from above it only
    ((True, True, False), math.inf),
    ((False, False, False), math.inf),
])
def test_the_crossover_is_zero_where_cuda_wins_at_every_grid_size(wins, want):
    assert cal._crossover((16, 64, 256), wins) == want


def test_calibrate_records_zero_where_cuda_always_wins(monkeypatch):
    """A measurement in which "cuda" wins at every size routes every size
    to "cuda", those below the grid too."""
    times = iter([2.0, 1.0] * 64)  # (torch, cuda) per primitive and size
    monkeypatch.setattr(cal, "_time", lambda fn, iters, warmup: next(times))
    table = cal.calibrate(sizes=(16, 64), d=2, iters=1, warmup=0, save=False)
    assert table.thresholds == {p: 0.0 for p in cal.PRIMITIVES}
    auto = AutoBackend(cuda_backend=_Recording(), table=table)
    auto.lagged_sums(_t(np.random.RandomState(1).randn(5, 2)), 2)
    assert list(auto.routes) == [("lagged_sums", "cuda", 5)]


@pytest.mark.parametrize("samples, want", [
    ({128: [1.0, 1.0, 1.0], 512: [2.0, 2.0, 2.0]}, 128),
    ({128: [0.9, 1.0, 1.1], 512: [1.05, 1.1, 1.2]}, None),  # inside the spread
    ({128: [0.9, 1.0, 1.05], 512: [1.1, 1.2, 1.25]}, 128),  # a 0.2 gap, 0.15 spreads
    ({128: [2.0, 2.0, 2.0], 512: [1.0, 1.0, 1.0]}, None),  # the default is fastest
    ({128: [1.0], 256: [0.5]}, None),                        # the default was dropped
])
def test_a_block_is_recorded_only_beyond_the_spread_of_its_samples(samples, want):
    assert cal._fastest_beyond_spread(samples, 512) == want


def test_cli_show_and_bless(tmp_path, capsys):
    path = tmp_path / "calib.json"
    assert cal.main(["--show"]) == 0
    out = capsys.readouterr().out
    assert "crossover thresholds" in out and "tuned tile configs" in out

    def _payload(platform, device=None):
        t = _table({p: 128.0 for p in cal.PRIMITIVES}, platform=platform,
                   source="measured", device=device)
        t.blocks = {"fused_plan_update": {"block_t": 128}}
        return t.to_json()

    alien = tmp_path / "alien.json"
    alien.write_text(json.dumps(_payload("definitely-not-this-platform")))
    assert cal.main(["--bless", str(alien)]) == 1
    other_card = tmp_path / "card.json"
    other_card.write_text(json.dumps(_payload("cpu", device="NVIDIA H100 80GB HBM3")))
    assert cal.main(["--bless", str(other_card)]) == 1
    assert not path.exists()
    good = tmp_path / "good.json"
    good.write_text(json.dumps(_payload("cpu")))
    assert cal.main(["--bless", str(good)]) == 0
    assert path.exists()
    assert cal.load_table().blocks == {"fused_plan_update": {"block_t": 128}}


@pytest.mark.parametrize("body", [
    "{not json",                        # truncated / invalid JSON
    '{"thresholds": 42}',               # valid JSON, wrong structure
    '["a", "list"]',                    # valid JSON, wrong top type
    '{"platform": null, "thresholds": {"lagged_sums": "NaNish"}}',
])
def test_corrupt_cache_degrades_to_defaults_with_warning(tmp_path, body):
    (tmp_path / "calib.json").write_text(body)
    with pytest.warns(RuntimeWarning, match="corrupt calibration cache"):
        assert cal.load_table() is None
    with pytest.warns(RuntimeWarning):
        resolved = cal.resolve_table(autocalibrate=False)
    assert resolved.source == "default"
    assert set(resolved.thresholds) == set(cal.PRIMITIVES)


def test_cli_bless_rejects_corrupt_table(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text('{"thresholds": 42}')
    assert cal.main(["--bless", str(bad)]) == 1
    assert "refusing to bless" in capsys.readouterr().out
    assert cal.main(["--bless", str(tmp_path / "missing.json")]) == 1
    assert "cannot read" in capsys.readouterr().out
    assert not (tmp_path / "calib.json").exists()


# ------------------------------------------------- against the reference
def test_reads_a_table_the_reference_wrote(tmp_path):
    ref = jcal.CalibrationTable("cpu", {p: (256.0 if i % 3 else math.inf)
                                        for i, p in enumerate(jcal.PRIMITIVES)}, "measured")
    ref.blocks = {"fused_plan_update": {"block_t": 256}, "segment_csd": {"block_s": 4}}
    payload = ref.to_json()
    assert "device" not in payload
    (tmp_path / "calib.json").write_text(json.dumps(payload))
    loaded = cal.load_table()
    assert loaded is not None and loaded.source == "cache" and loaded.device is None
    assert loaded.thresholds == ref.thresholds and loaded.blocks == ref.blocks
    direct = cal.CalibrationTable.from_json(payload)
    assert (direct.platform, direct.thresholds, direct.source) == ("cpu", ref.thresholds,
                                                                   "measured")
    # and the port's table, with its device key, reads back into the reference
    back = jcal.CalibrationTable.from_json(json.loads(json.dumps(loaded.to_json())))
    assert back.thresholds == ref.thresholds and back.blocks == ref.blocks


def test_tables_of_another_platform_or_card_are_ignored(tmp_path):
    path = tmp_path / "calib.json"
    for platform, device in (("tpu", None), ("cpu", "NVIDIA H100 80GB HBM3"),
                             ("cuda", "NVIDIA H100 80GB HBM3")):
        path.write_text(json.dumps(_table({p: 1.0 for p in cal.PRIMITIVES}, platform=platform,
                                          device=device).to_json()))
        assert cal.load_table() is None
        assert cal.resolve_table(autocalibrate=False).source == "default"
    path.write_text(json.dumps(_table({p: 1.0 for p in cal.PRIMITIVES}).to_json()))
    assert cal.load_table().thresholds == {p: 1.0 for p in cal.PRIMITIVES}


class _RefRecording(PallasBackend):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __getattribute__(self, name):
        attr = object.__getattribute__(self, name)
        if name in jcal.PRIMITIVES:
            calls = object.__getattribute__(self, "calls")

            def wrapped(*args, **kwargs):
                calls.append(name)
                return attr(*args, **kwargs)

            return wrapped
        return attr


THRESHOLD = 48  # rows, banded dimension, or staged samples S * L


def _inputs(prim, size, seed=0):
    """numpy arguments of one call of ``prim`` whose problem size is
    ``size``: rows of a windowed contraction, S * L of the segment DFT (L =
    16), the banded dimension."""
    rng = np.random.RandomState(seed + size)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    if prim in ("segment_fft_power", "segment_csd"):
        return (f(size // 16, 16, 2), np.hanning(16).astype(np.float32))
    if prim == "banded_matvec":
        return (f(size, 5), f(size))
    if prim in ("lagged_sums",):
        return (f(size, 2), 4)
    if prim == "windowed_moments":
        return (f(size, 2), 8)
    mask = np.ones(size, bool)
    y = f(size + 15, 2)
    if prim == "masked_lagged_sums":
        return (y, mask, 4)
    if prim == "fused_lagged_moments":
        return (y, mask, 4, 8)
    return (y, mask, 0, 4, (8,), (16,), (8,), (np.hanning(16).astype(np.float32),))


def _convert(args, to):
    """numpy arrays (also inside tuples) through ``to``; the rest as is."""
    if isinstance(args, np.ndarray):
        return to(args)
    if isinstance(args, tuple):
        return tuple(_convert(a, to) for a in args)
    return args


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _flat(o)]
    return [] if out is None else [np.asarray(out)]


@pytest.mark.parametrize("prim", list(cal.PRIMITIVES))
def test_routing_parity_with_the_reference(prim):
    """The same thresholds in the reference's AutoBackend and the port's:
    just below, at and above the threshold the port routes to "cuda"
    exactly where the reference routes to "pallas" (interpret mode here),
    and the outputs agree within tests/test_backend.py's tolerances."""
    thresholds = {p: math.inf for p in cal.PRIMITIVES}
    thresholds[prim] = float(THRESHOLD)
    ref_rec, rec = _RefRecording(), _Recording()
    ref_auto = RefAutoBackend(pallas_backend=ref_rec,
                              table=jcal.CalibrationTable("cpu", dict(thresholds), "test"))
    auto = AutoBackend(cuda_backend=rec, table=_table(thresholds))
    step = 16 if prim.startswith("segment") else 1
    for size in (THRESHOLD - step, THRESHOLD, THRESHOLD + step):
        args = _inputs(prim, size)
        want = getattr(ref_auto, prim)(*_convert(args, jnp.asarray))
        got = getattr(auto, prim)(*_convert(args, torch.from_numpy))
        assert len(rec.calls) == len(ref_rec.calls), (size, rec.calls, ref_rec.calls)
        spectral = prim.startswith("segment") or prim == "fused_plan_update"
        tol = dict(rtol=1e-3, atol=1e-4 * 16) if spectral else dict(rtol=1e-5, atol=1e-4)
        for g, w in zip(_flat(got), _flat(want)):
            np.testing.assert_allclose(g, w, **tol)
    assert rec.calls == ref_rec.calls == [prim, prim]
    assert [s for (_, r, s) in auto.routes if r == "cuda"] == [THRESHOLD, THRESHOLD + step]


def _batched(prim, one, B):
    """``one``'s arguments for B identical problems: arrays stacked on a
    leading axis; the megakernel's z0 per problem, the tapers shared."""
    out = [torch.from_numpy(np.stack([a] * B)) if isinstance(a, np.ndarray) else a
           for a in one]
    if prim.startswith("segment"):
        out[1] = torch.from_numpy(one[1])
    if prim == "fused_plan_update":
        out[2] = torch.zeros(B, dtype=torch.int32)
        out[7] = (torch.from_numpy(one[7][0]),)
    return tuple(out)


@pytest.mark.parametrize("prim", ["masked_lagged_sums", "fused_lagged_moments",
                                  "fused_plan_update", "segment_fft_power", "segment_csd"])
def test_a_batch_is_sized_per_problem_not_by_its_leading_axis(prim):
    """B = 37 problems of L rows, or of S segments of length L (the
    primitives a session's tick and its queries call with a leading tenant
    axis), route as one problem does, never by the 37: below the threshold
    every problem stays on "torch", at it every problem goes to "cuda"."""
    B = 37
    for size, route in ((THRESHOLD - 16, "torch"), (THRESHOLD, "cuda")):
        rec = _Recording()
        auto = AutoBackend(cuda_backend=rec,
                           table=_table({p: float(THRESHOLD) for p in cal.PRIMITIVES}))
        one = _inputs(prim, size)
        got = getattr(auto, prim)(*_batched(prim, one, B))
        assert list(auto.routes) == [(prim, route, size)]
        assert rec.calls == ([prim] if route == "cuda" else [])
        want = getattr(TorchBackend(), prim)(*_convert(one, torch.from_numpy))
        for g, w in zip(_flat(got), _flat(want)):
            assert g.shape == (B,) + w.shape
            np.testing.assert_allclose(g[5], w, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("B", [1, 37])
def test_the_welch_chunk_kernel_is_sized_per_tenant(B):
    """A session's Welch members pass each tenant's candidate segments on a
    leading axis: "auto" sizes the call by one tenant's S * L samples,
    whatever the number of tenants, and the powers are the folded call's."""
    from repro_torch.core.estimators.spectral import welch_chunk_kernel

    rng = np.random.RandomState(3)
    y, mask = _t(rng.randn(B, 80, 2)), torch.ones((B, 65), dtype=torch.bool)
    auto = AutoBackend(table=_table({p: math.inf for p in cal.PRIMITIVES}))
    z0 = torch.zeros(B, dtype=torch.int32)
    got = welch_chunk_kernel(16, 8, 1.0, auto, "cpu")(y, mask, z0)
    # 9 candidate starts a tenant (0, 8, ..., 64) of 16 samples each
    assert list(auto.routes) == [("segment_fft_power", "torch", 9 * 16)]
    want = welch_chunk_kernel(16, 8, 1.0, TorchBackend(), "cpu")(y[-1:], mask[-1:],
                                                                 torch.zeros(1, dtype=torch.int32))
    assert torch.equal(got["psd"][-1], want["psd"][0])


def test_cli_show_imports_neither_jax_nor_repro(tmp_path):
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
            "from repro_torch.core import calibrate\n"
            "rc = calibrate.main(['--show'])\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules"
            " if sys.modules[m] is not None)\n"
            "sys.exit(rc)\n")
    cache = tmp_path / "c.json"
    cache.write_text(json.dumps(_table({p: 2048.0 for p in cal.PRIMITIVES}).to_json()))
    env = {"PATH": "/usr/bin:/bin", "REPRO_TORCH_CALIB_CACHE": str(cache),
           "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "source: cache" in proc.stdout
    assert proc.stdout.count("2048.0") == len(cal.PRIMITIVES)
    mod = subprocess.run([sys.executable, "-m", "repro_torch.core.calibrate", "--show"],
                         capture_output=True, text=True, timeout=120,
                         env={**env, "PYTHONPATH": str(ROOT / "src")})
    assert mod.returncode == 0, mod.stderr
    assert mod.stdout == proc.stdout


def test_calibrate_rejects_an_empty_grid():
    with pytest.raises(ValueError, match="grid size"):
        cal.calibrate(sizes=(), save=False)
