"""The port stands alone: no JAX, nothing of `repro`, and the card unless
the CPU is asked for."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs


def test_imports_and_runs_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import numpy as np, repro_torch\n"
        "from repro_torch.core import plan\n"
        "x = np.random.default_rng(0).standard_normal((500, 2)).astype('float32')\n"
        "out = repro_torch.analyze(x, [plan.autocovariance_request(3), plan.moments_request(8),"
        " plan.welch_request(32, 16)], chunk_size=120, device='cpu')\n"
        "assert out['autocovariance'].shape == (4, 2, 2)\n"
        "import torch\n"
        "from repro_torch.core.estimators import spatial, spectral, stats\n"
        "from repro_torch.kernels.banded_matvec import ops, ref\n"
        "xt = torch.from_numpy(x)\n"
        "assert repro_torch.windowed_moments(xt, 16)['var'].shape == (485, 2)\n"
        "assert repro_torch.welch_csd(xt, 32, 16)[1].shape == (17, 2, 2)\n"
        "fit = repro_torch.fit_banded_ar(xt, 1, n_steps=2, step_size=0.5)\n"
        "assert fit.diags.shape == (2, 3) and fit.nll_trace.shape == (2,)\n"
        "cfg = repro_torch.get_arch('danube').reduced()\n"
        "lm = repro_torch.init_params(cfg, seed=0, dtype=torch.float32, device='cpu')\n"
        "eng = repro_torch.ServeEngine(cfg, lm, max_len=24, device='cpu')\n"
        "out = eng.generate(np.zeros((2, 20), np.int32), 4)\n"
        "assert out.tokens.shape == (2, 4) and (out.tokens >= 0).all()\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_session_runs_without_jax():
    """The multi-tenant session, its service and the integrity checks with
    JAX and the reference package unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import numpy as np, torch, repro_torch\n"
        "from repro_torch.core import integrity\n"
        "from repro_torch.serving import rolling\n"
        "s = repro_torch.FrameSession(d=2, num_users=3, window=64, num_buckets=4, device='cpu')\n"
        "s.autocovariance(3); s.moments(8); s.welch(16, 8)\n"
        "x = np.random.default_rng(0).standard_normal((3, 16, 2)).astype('float32')\n"
        "verdict, clean = integrity.sentinel_scan(torch.from_numpy(x))\n"
        "s.ingest(np.arange(3), clean); s.ingest([2, 0], x[:2])\n"
        "out = s.query_batch([0, 2])\n"
        "assert out['autocovariance'].shape == (2, 4, 2, 2) and verdict.all()\n"
        "t = repro_torch.FrameSession(d=2, num_users=3, window=64, num_buckets=4, device='cpu')\n"
        "t.autocovariance(3); t.moments(8); t.welch(16, 8)\n"
        "t.import_state(repro_torch.session_state_from_numpy("
        "repro_torch.session_state_to_numpy(s.export_state()), device='cpu'))\n"
        "assert (t.query(2)['welch'][1] == s.query(2)['welch'][1]).all() and t.audit().all()\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_tensor_parallel_imports_without_jax():
    """`parallel/tensor.py` and the tensor-parallel cells with JAX and the
    reference package unimportable: the layout, the counting mesh's trace
    of a rank's prefill, and a shard."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import torch\n"
        "from repro_torch.parallel import tensor as tp\n"
        "from repro_torch.configs import ShapeConfig, get_arch\n"
        "from repro_torch.launch.costing import trace_cell\n"
        "from repro_torch.launch.mesh import make_test_mesh\n"
        "from repro_torch.models import init_params\n"
        "cfg = get_arch('qwen3').reduced()\n"
        "assert tp.head_layout(get_arch('qwen3'), 16) == (1, 1)\n"
        "tr = trace_cell(cfg, ShapeConfig('p', 16, 2, 'prefill'), mesh=make_test_mesh(1, 2))\n"
        "assert tr.collective_counts == {'all-reduce': 2 * cfg.n_layers + 1}\n"
        "assert tr.executed_collective_counts == {'all-gather': 2 * cfg.n_layers + 1}\n"
        "m = init_params(cfg, seed=0, dtype=torch.float32, device='cpu')\n"
        "assert tp.shard_params(m, make_test_mesh(1, 2), rank=1).embed.shape == (256, 64)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_source_imports_jax_or_repro():
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").rglob("*.py")))
    assert len(files) > 10
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b|import repro\.|from repro[. ])",
                         re.M)
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    import numpy as np

    from repro_torch import (BandedARModel, FrameSession, ServeEngine, SeriesFrame, StatPlan,
                             analyze, get_arch)
    from repro_torch.core.backend import get_backend
    from repro_torch.core.estimators import fit_ar_mle, fit_ar_sgd
    from repro_torch.core.graphs import line_graph, simulate_traffic_dbn
    from repro_torch.core.estimators.spectral import hann_window, welch_chunk_kernel
    from repro_torch.core.plan import autocovariance_request
    from repro_torch.launch import serve
    from repro_torch.models import (fake_frame_embeds, fake_patch_embeds, init_params,
                                    params_from_numpy, params_to_numpy)
    from repro_torch.serving import StatsGateway

    x = np.zeros((64, 2), np.float32)
    cfg = get_arch("danube").reduced()
    cpu_model = init_params(cfg, device="cpu")
    tree = params_to_numpy(cpu_model)
    moe_cfg = get_arch("llama4").reduced()
    moe_model = init_params(moe_cfg, device="cpu")
    moe_tree = params_to_numpy(moe_model)
    mla_cfg = get_arch("deepseek-v2").reduced()
    mla_model = init_params(mla_cfg, device="cpu")
    mla_tree = params_to_numpy(mla_model)
    hybrid_cfg = get_arch("zamba2").reduced()
    hybrid_model = init_params(hybrid_cfg, device="cpu")
    hybrid_tree = params_to_numpy(hybrid_model)
    xlstm_cfg = get_arch("xlstm").reduced()
    xlstm_model = init_params(xlstm_cfg, device="cpu")
    xlstm_tree = params_to_numpy(xlstm_model)
    whisper_cfg = get_arch("whisper").reduced()
    whisper_model = init_params(whisper_cfg, device="cpu")
    whisper_tree = params_to_numpy(whisper_model)
    llava_cfg = get_arch("llava").reduced()
    llava_model = init_params(llava_cfg, device="cpu")
    llava_tree = params_to_numpy(llava_model)
    stub_gen = torch.Generator()
    for call in (lambda: SeriesFrame.from_array(x), lambda: SeriesFrame.from_chunks([x]),
                 lambda: FrameSession(d=2, num_users=4),
                 lambda: StatPlan([autocovariance_request(2)], d=2),
                 lambda: analyze(x, [autocovariance_request(2)]), lambda: get_backend(),
                 lambda: BandedARModel.from_numpy(np.zeros((4, 3))), lambda: hann_window(8),
                 lambda: welch_chunk_kernel(8, 4, 1.0, get_backend(device="cpu")),
                 lambda: StatsGateway(FrameSession(d=2, num_users=2)),
                 lambda: init_params(cfg), lambda: params_from_numpy(tree, cfg),
                 lambda: ServeEngine(cfg, cpu_model, max_len=8),
                 lambda: ServeEngine(cfg, cpu_model, max_len=8, quantize=True),
                 lambda: init_params(moe_cfg), lambda: params_from_numpy(moe_tree, moe_cfg),
                 lambda: ServeEngine(moe_cfg, moe_model, max_len=8, quantize=True),
                 lambda: init_params(mla_cfg), lambda: params_from_numpy(mla_tree, mla_cfg),
                 lambda: ServeEngine(mla_cfg, mla_model, max_len=8),
                 lambda: init_params(hybrid_cfg),
                 lambda: params_from_numpy(hybrid_tree, hybrid_cfg),
                 lambda: ServeEngine(hybrid_cfg, hybrid_model, max_len=8),
                 lambda: init_params(xlstm_cfg), lambda: params_from_numpy(xlstm_tree, xlstm_cfg),
                 lambda: ServeEngine(xlstm_cfg, xlstm_model, max_len=8, quantize=True),
                 lambda: init_params(whisper_cfg),
                 lambda: params_from_numpy(whisper_tree, whisper_cfg),
                 lambda: ServeEngine(whisper_cfg, whisper_model, max_len=8),
                 lambda: ServeEngine(whisper_cfg, whisper_model, max_len=8, quantize=True),
                 lambda: init_params(llava_cfg), lambda: params_from_numpy(llava_tree, llava_cfg),
                 lambda: ServeEngine(llava_cfg, llava_model, max_len=8),
                 lambda: fake_frame_embeds(stub_gen, 1, 4, 8),
                 lambda: fake_patch_embeds(stub_gen, 1, 4, 8),
                 lambda: serve.main(["--arch", "xlstm", "--reduced"]),
                 lambda: serve.main(["--arch", "deepseek-v2", "--reduced"]),
                 lambda: serve.main(["--arch", "llama4", "--reduced"]),
                 lambda: serve.main(["--arch", "danube", "--reduced"]),
                 lambda: fit_ar_mle(x, 1, n_steps=1), lambda: fit_ar_sgd(x, 1, n_steps=1),
                 lambda: simulate_traffic_dbn(line_graph(4), np.zeros(4, np.float32), 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert get_backend(device="cpu").name == "cuda"  # the kernels' plain versions on the CPU


def test_store_and_streaming_estimators_run_without_jax(tmp_path):
    """The overlapping block store, the sharded frame, the map-reduce paths,
    the streaming front-ends, prediction, the generator and the distribution
    layer (``psum_tree`` and ``halo_exchange`` on a one-rank gloo mesh) with
    JAX and the reference package unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import numpy as np, torch\n"
        "from repro_torch import SeriesFrame, StreamingEstimator, TimeSeriesStore\n"
        "from repro_torch.core import OverlapSpec, block_window_map_reduce, "
        "scan_window_map_reduce, serial_window_map_reduce\n"
        "from repro_torch.core.estimators import (arma_forecast, block_levinson, "
        "lag_sum_engine, streaming_autocovariance, streaming_welch, welch_engine)\n"
        "from repro_torch.timeseries import random_stable_var, regularize, simulate_var\n"
        "g = torch.Generator().manual_seed(0)\n"
        "A = random_stable_var(g, 2, 2, device='cpu')\n"
        "x = simulate_var(g, A, 600, device='cpu')\n"
        "f = SeriesFrame.from_sharded(x, block_size=128, device='cpu')\n"
        "f.autocovariance(3); f.moments(8); f.welch(16, 8)\n"
        "g = f.collect()['autocovariance']; f.append(x[:50]); f.collect()\n"
        "store = TimeSeriesStore.from_series(x, 100, 0, 3, device='cpu')\n"
        "est = StreamingEstimator.from_store(lag_sum_engine(3, 2, device='cpu'), store, 77)\n"
        "assert torch.allclose(est.finalize(streaming_autocovariance), g, rtol=1e-5, atol=1e-5)\n"
        "w = StreamingEstimator(welch_engine(16, 8, d=2, device='cpu')).ingest(x)\n"
        "assert w.finalize(streaming_welch)[1].shape == (9, 2)\n"
        "spec = OverlapSpec(600, 64, 1, 1)\n"
        "k = lambda v: v[0] * v[-1]\n"
        "s = serial_window_map_reduce(k, x, 1, 1)\n"
        "assert torch.allclose(block_window_map_reduce(k, x, spec), s, atol=1e-4)\n"
        "assert torch.allclose(scan_window_map_reduce(k, x, spec), s, atol=1e-4)\n"
        "Ah, _, _ = block_levinson(g, 2)\n"
        "assert arma_forecast(Ah, torch.zeros(0, 2, 2), x, 4).shape == (4, 2)\n"
        "t = torch.arange(10.0); assert regularize(t, x[:10], t + 0.5)[:9].shape == (9, 2)\n"
        "from repro_torch.core.halo import halo_exchange\n"
        "from repro_torch.parallel import collective_count, data_mesh, psum_tree\n"
        f"mesh = data_mesh(1, 0, 'file://{tmp_path / 'rendezvous'}', device='cpu')\n"
        "tree = {'a': x[:3], 'n': torch.tensor([3])}\n"
        "out = psum_tree(tree, mesh)\n"
        "assert torch.equal(out['a'], x[:3]) and torch.equal(out['n'], tree['n'])\n"
        "assert collective_count() == 2  # one per dtype\n"
        "h = halo_exchange(x[:8], 2, 3, mesh)\n"
        "assert torch.equal(h[2:10], x[:8]) and not h[:2].any() and not h[10:].any()\n"
        "torch.distributed.destroy_process_group()\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_store_and_estimator_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    import numpy as np

    from repro_torch import SeriesFrame, TimeSeriesStore, session_state_from_numpy
    from repro_torch.core.estimators import lag_sum_engine, moment_engine, welch_engine
    from repro_torch.timeseries import (random_invertible_ma, random_stable_var, simulate_var,
                                        simulate_varma, simulate_vma)

    x = np.zeros((64, 2), np.float32)
    A = np.zeros((1, 2, 2), np.float32)
    snapshot = {"group_0": {"lanes": {"length": np.zeros(1, np.int32)},
                            "counts": np.zeros(1)}}
    for call in (lambda: SeriesFrame.from_sharded(x), lambda: SeriesFrame.from_chunks([x]),
                 lambda: TimeSeriesStore.from_series(x, 16, 0, 2),
                 lambda: lag_sum_engine(2, 2), lambda: moment_engine(4, 2),
                 lambda: welch_engine(8, 4, d=2), lambda: random_stable_var(None, 1, 2),
                 lambda: random_invertible_ma(None, 1, 2), lambda: simulate_var(None, A, 8),
                 lambda: simulate_vma(None, A, 8), lambda: simulate_varma(None, A, A, 8),
                 lambda: session_state_from_numpy(snapshot)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_forecast_checkpoint_and_gateway_run_without_jax():
    """Forecasts, checkpoints, chaos, the fault runtime and the gateway with
    JAX and the reference package unimportable: a gateway serves forecasts,
    snapshots, and a restarted one restores them."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import asyncio, tempfile, numpy as np\n"
        "from repro_torch.core import forecast\n"
        "from repro_torch.checkpoint import manager\n"
        "from repro_torch.runtime import chaos, fault\n"
        "from repro_torch.serving import gateway\n"
        "from repro_torch import FrameSession\n"
        "def sess():\n"
        "    s = FrameSession(d=2, num_users=3, device='cpu')\n"
        "    s.welch(16, 8); s.forecast(3, model='auto', p=2, max_period=8)\n"
        "    s.anomaly_scores(model='ar', p=2)\n"
        "    return s\n"
        "d = tempfile.mkdtemp()\n"
        "cfg = gateway.GatewayConfig(checkpoint_dir=d, snapshot_every=1, sentinel=True)\n"
        "x = np.random.default_rng(0).standard_normal((3, 40, 2)).astype('float32')\n"
        "async def first():\n"
        "    gw = gateway.StatsGateway(sess(), cfg)\n"
        "    futs = [gw.submit_ingest(u, x[u]) for u in range(3)]\n"
        "    await gw.tick(); await asyncio.gather(*futs)\n"
        "    q = gw.submit_query(1); await gw.tick(); out = await q\n"
        "    await gw.stop(); return out\n"
        "async def second():\n"
        "    gw = gateway.StatsGateway(sess(), cfg)\n"
        "    q = gw.submit_query(1); await gw.tick(); out = await q\n"
        "    await gw.stop(); return out\n"
        "a = asyncio.run(first()); b = asyncio.run(second())\n"
        "assert a['forecast']['pred'].shape == (3, 2) and a['forecast']['period'].dtype == np.int32\n"
        "assert (a['forecast']['pred'] == b['forecast']['pred']).all()\n"
        "assert fault.plan_remesh(8).world == 8 and chaos.installed() is None\n"
        "assert manager.latest_step(d) is not None\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_calibration_and_policy_run_without_jax(tmp_path):
    """The calibration module, its "auto" backend and the circuit breaker
    with JAX and the reference package unimportable: a measured table is
    saved, read back and steers the dispatch."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import math, os, torch\n"
        "from repro_torch.core import (AutoBackend, CircuitBreakerBackend, calibrate,\n"
        "                              get_backend, set_default_backend)\n"
        "from repro_torch.runtime import chaos\n"
        f"os.environ['REPRO_TORCH_CALIB_CACHE'] = {str(tmp_path / 'c.json')!r}\n"
        "t = calibrate.calibrate(sizes=(16, 32), d=2, iters=1, warmup=0, tune_blocks=True)\n"
        "assert calibrate.load_table().thresholds == t.thresholds\n"
        "auto = AutoBackend(table=calibrate.default_table('cpu'))\n"
        "x = torch.randn(40, 2)\n"
        "assert torch.equal(auto.lagged_sums(x, 3), get_backend('torch', 'cpu').lagged_sums(x, 3))\n"
        "br = CircuitBreakerBackend(trip_after=1, cooldown_calls=2)\n"
        "with chaos.scoped(chaos.FaultInjector().fail('backend.lagged_sums', calls={0})):\n"
        "    br.lagged_sums(x, 3)\n"
        "assert br.breaker_metrics()['trips'] == 1\n"
        "set_default_backend('auto'); assert get_backend(None, 'cpu').name == 'auto'\n"
        "assert calibrate.main(['--show']) == 0\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_paper_estimators_graphs_and_quant_run_without_jax():
    """The §5 MLE, fit_ma, differencing, graphs, the paper's VAR configs and
    int8 serving with JAX and the reference package unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import numpy as np, torch, repro_torch\n"
        "from repro_torch.configs import PAPER_VAR_CONFIGS, SHAPES, cell_is_runnable, get_arch\n"
        "from repro_torch.core import (difference, difference_blocked, graphs, halo_exchange,\n"
        "                              halo_exchange_grouped, integrate)\n"
        "from repro_torch.core.differencing import fractional_difference\n"
        "from repro_torch.core.estimators import (ar_conditional_nll, autocovariance, fit_ar_mle,\n"
        "                                         fit_ar_sgd, fit_ma, optimal_step_size)\n"
        "from repro_torch.serving.quant import quantize_tree, tree_param_bytes\n"
        "from repro_torch.models import params_to_tree\n"
        "assert PAPER_VAR_CONFIGS['varma'].q == 1 and len(SHAPES) == 4\n"
        "assert cell_is_runnable(get_arch('danube'), SHAPES[0])[0]\n"
        "x = np.random.default_rng(0).standard_normal((400, 2)).astype('float32')\n"
        "fit = fit_ar_mle(x, 1, n_steps=3, block_size=64, device='cpu')\n"
        "assert fit.A.shape == (1, 2, 2) and fit.nll_trace.shape == (3,)\n"
        "assert fit_ar_sgd(x, 1, n_steps=3, batch=8, device='cpu').A.shape == (1, 2, 2)\n"
        "xt = torch.from_numpy(x)\n"
        "assert ar_conditional_nll(fit.A, torch.eye(2), xt).ndim == 0\n"
        "assert float(optimal_step_size(xt)) > 0\n"
        "B, s = fit_ma(autocovariance(xt, 6, 'standard'), 1)\n"
        "assert B.shape == (1, 2, 2) and s.shape == (2, 2)\n"
        "X = torch.cumsum(xt, 0)\n"
        "assert torch.allclose(integrate(difference(X), X[:1]), X, atol=1e-4)\n"
        "assert fractional_difference(X, 0.4, 8).shape == (392, 2)\n"
        "g = graphs.grid_graph(4, 4); p = graphs.make_graph_partition(g, 4, 1)\n"
        "k = lambda xc, nb, m: (xc * torch.where(m[:, None], nb, 0.0).sum(0)).sum()\n"
        "assert graphs.graph_window_map_reduce(k, xt[:16], g, p).ndim == 0\n"
        "tr = graphs.simulate_traffic_dbn(graphs.line_graph(8), torch.full((8,), 0.4), 5,\n"
        "                                 device='cpu')\n"
        "assert tr.shape == (6, 8)\n"
        "cfg = get_arch('danube').reduced()\n"
        "lm = repro_torch.init_params(cfg, seed=0, dtype=torch.float32, device='cpu')\n"
        "eng = repro_torch.ServeEngine(cfg, lm, max_len=24, quantize=True, device='cpu')\n"
        "assert eng.generate(np.zeros((2, 20), np.int32), 3).tokens.shape == (2, 3)\n"
        "assert tree_param_bytes(quantize_tree(params_to_tree(lm))) > 0\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_moe_serving_runs_without_jax():
    """The MoE family (models/moe.py, the transformer's MoE branch), its
    weights carried out and in, int8 serving of its expert leaves and the
    config shims with JAX and the reference package unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import numpy as np, torch, repro_torch\n"
        "from repro_torch.configs import (glm4_9b, llama4_maverick_400b, phi3_medium_14b,\n"
        "                                 qwen3_0_6b)\n"
        "from repro_torch.models import (forward, moe_apply, params_from_numpy,\n"
        "                                params_to_numpy)\n"
        "from repro_torch.models.layers import expert_init\n"
        "assert llama4_maverick_400b.CONFIG.moe.num_experts == 128\n"
        "assert qwen3_0_6b.CONFIG.qk_norm and glm4_9b.CONFIG.n_kv_heads == 2\n"
        "assert phi3_medium_14b.CONFIG.d_model == 5120\n"
        "cfg = repro_torch.get_arch('llama4').reduced()\n"
        "lm = repro_torch.init_params(cfg, seed=0, dtype=torch.float32, device='cpu')\n"
        "x = torch.randn(2, 6, cfg.d_model)\n"
        "out, aux = moe_apply(lm.layers[0].mlp, x, cfg)\n"
        "assert out.shape == x.shape and set(aux) == {'lb_loss', 'z_loss'}\n"
        "tok = torch.zeros((2, 20), dtype=torch.long)\n"
        "logits, aux = forward(lm, {'tokens': tok}, cfg, return_aux=True)\n"
        "assert logits.shape == (2, 20, cfg.vocab) and float(aux['z_loss']) > 0\n"
        "back = params_from_numpy(params_to_numpy(lm), cfg, device='cpu')\n"
        "assert torch.equal(forward(back, {'tokens': tok}, cfg), logits)\n"
        "for quantize in (False, True):\n"
        "    eng = repro_torch.ServeEngine(cfg, lm, max_len=24, quantize=quantize, device='cpu')\n"
        "    assert eng.generate(np.zeros((2, 20), np.int32), 3).tokens.shape == (2, 3)\n"
        "g = torch.Generator().manual_seed(0)\n"
        "assert expert_init(g, (2, 8, 4), 0.5, torch.bfloat16).dtype == torch.bfloat16\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_hybrid_serving_runs_without_jax():
    """The Mamba2 mixer (models/ssm.py), the zamba2 hybrid (models/zamba.py),
    the config shim, its weights carried out and in, the nested cache and
    int8 serving, with JAX and the reference package unimportable: a
    reduced zamba2 forward on the CPU."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import numpy as np, torch, repro_torch\n"
        "from repro_torch.configs import zamba2_7b\n"
        "from repro_torch.models import (cache_spec, forward, params_from_numpy,\n"
        "                                params_to_numpy, prefill, ssm, zamba)\n"
        "assert zamba2_7b.CONFIG.ssm.chunk == 256 and zamba2_7b.CONFIG.n_layers == 81\n"
        "cfg = repro_torch.get_arch('zamba2').reduced()\n"
        "lm = repro_torch.init_params(cfg, seed=0, dtype=torch.float32, device='cpu')\n"
        "assert isinstance(lm, zamba.Zamba)\n"
        "x = torch.randn(2, 40, cfg.d_model)\n"
        "y, st = ssm.mamba2_apply(lm.mamba_layers[0].mixer, x, cfg, return_state=True)\n"
        "assert y.shape == x.shape and st['ssd'].dtype == torch.float32\n"
        "tok = torch.zeros((2, 20), dtype=torch.long)\n"
        "logits = forward(lm, {'tokens': tok}, cfg)\n"
        "assert logits.shape == (2, 20, cfg.vocab) and torch.isfinite(logits).all()\n"
        "_, cache = prefill(lm, {'tokens': tok}, cfg)\n"
        "spec = cache_spec(cfg, 2, 20)\n"
        "assert cache['attn']['k'].shape == tuple(spec['attn']['k'].shape)\n"
        "back = params_from_numpy(params_to_numpy(lm), cfg, device='cpu')\n"
        "assert torch.equal(forward(back, {'tokens': tok}, cfg), logits)\n"
        "for quantize in (False, True):\n"
        "    eng = repro_torch.ServeEngine(cfg, lm, max_len=24, quantize=quantize, device='cpu')\n"
        "    assert eng.generate(np.zeros((2, 20), np.int32), 3).tokens.shape == (2, 3)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_xlstm_serving_runs_without_jax():
    """The xLSTM mixers (models/xlstm.py), the LM (models/xlstm_lm.py), the
    config shim, its weights carried out and in, the float32 state cache
    and int8 serving, with JAX and the reference package unimportable: a
    reduced xlstm-125m on the CPU."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import numpy as np, torch, repro_torch\n"
        "from repro_torch.configs import xlstm_125m\n"
        "from repro_torch.models import (cache_spec, forward, params_from_numpy,\n"
        "                                params_to_numpy, prefill, xlstm, xlstm_lm)\n"
        "assert xlstm_125m.CONFIG.slstm_every == 2 and xlstm_125m.CONFIG.n_layers == 12\n"
        "cfg = repro_torch.get_arch('xlstm').reduced()\n"
        "lm = repro_torch.init_params(cfg, seed=0, dtype=torch.bfloat16, device='cpu')\n"
        "assert isinstance(lm, xlstm_lm.XLSTM)\n"
        "x = torch.randn(2, 40, cfg.d_model, dtype=torch.bfloat16)\n"
        "y, st = xlstm.mlstm_apply(lm.pairs[0].mlstm, x, cfg, return_state=True)\n"
        "assert y.shape == x.shape and st['C'].dtype == torch.float32\n"
        "y, st = xlstm.slstm_apply(lm.pairs[0].slstm, x, cfg, return_state=True)\n"
        "assert y.shape == x.shape and st['c'].dtype == torch.float32\n"
        "tok = torch.zeros((2, 20), dtype=torch.long)\n"
        "logits = forward(lm, {'tokens': tok}, cfg)\n"
        "assert logits.shape == (2, 20, cfg.vocab) and torch.isfinite(logits).all()\n"
        "_, cache = prefill(lm, {'tokens': tok}, cfg)\n"
        "spec = cache_spec(cfg, 2, 20, dtype=torch.bfloat16)\n"
        "assert cache['m']['C'].shape == tuple(spec['m']['C'].shape)\n"
        "assert spec['s']['h'].dtype == torch.float32\n"
        "back = params_from_numpy(params_to_numpy(lm), cfg, device='cpu')\n"
        "assert torch.equal(forward(back, {'tokens': tok}, cfg), logits)\n"
        "for quantize in (False, True):\n"
        "    eng = repro_torch.ServeEngine(cfg, lm, max_len=24, dtype=torch.bfloat16,\n"
        "                                  quantize=quantize, device='cpu')\n"
        "    assert eng.generate(np.zeros((2, 20), np.int32), 3).tokens.shape == (2, 3)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_encdec_and_vlm_serving_run_without_jax():
    """The encoder-decoder (models/encdec.py), the VLM branch of the
    transformer, the frontend stubs (models/vlm_stub.py), both config shims,
    their weights carried out and in, and serving in bf16 and int8, with JAX
    and the reference package unimportable: reduced whisper-base and
    llava-next-34b on the CPU."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import numpy as np, torch, repro_torch\n"
        "from repro_torch.configs import llava_next_34b, whisper_base\n"
        "from repro_torch.models import (encdec, encode, fake_frame_embeds, fake_patch_embeds,\n"
        "                                forward, params_from_numpy, params_to_numpy, prefill)\n"
        "assert whisper_base.CONFIG.enc_layers == 6 and llava_next_34b.CONFIG.n_patches == 2880\n"
        "gen = torch.Generator().manual_seed(0)\n"
        "tok = torch.zeros((2, 10), dtype=torch.long)\n"
        "cfg = repro_torch.get_arch('whisper').reduced()\n"
        "lm = repro_torch.init_params(cfg, seed=0, dtype=torch.bfloat16, device='cpu')\n"
        "assert isinstance(lm, encdec.EncDec)\n"
        "frames = fake_frame_embeds(gen, 2, 30, cfg.d_model, device='cpu')\n"
        "assert encode(lm, frames, cfg).shape == (2, 30, cfg.d_model)\n"
        "logits = forward(lm, {'frames': frames, 'tokens': tok}, cfg)\n"
        "assert logits.shape == (2, 10, cfg.vocab) and torch.isfinite(logits).all()\n"
        "_, cache = prefill(lm, {'frames': frames, 'tokens': tok}, cfg)\n"
        "assert cache['cross']['k'].shape[2] == 30 and cache['self']['k'].shape[2] == 10\n"
        "back = params_from_numpy(params_to_numpy(lm), cfg, device='cpu')\n"
        "assert torch.equal(forward(back, {'frames': frames, 'tokens': tok}, cfg), logits)\n"
        "for quantize in (False, True):\n"
        "    eng = repro_torch.ServeEngine(cfg, lm, max_len=16, dtype=torch.bfloat16,\n"
        "                                  quantize=quantize, device='cpu')\n"
        "    out = eng.generate(np.zeros((2, 10), np.int32), 3, extra={'frames': frames})\n"
        "    assert out.tokens.shape == (2, 3)\n"
        "cfg = repro_torch.get_arch('llava').reduced()\n"
        "lm = repro_torch.init_params(cfg, seed=0, dtype=torch.bfloat16, device='cpu')\n"
        "patches = fake_patch_embeds(gen, 2, cfg.n_patches, cfg.d_model, device='cpu')\n"
        "logits = forward(lm, {'patch_embeds': patches, 'tokens': tok}, cfg)\n"
        "assert logits.shape == (2, 10 + cfg.n_patches, cfg.vocab)\n"
        "back = params_from_numpy(params_to_numpy(lm), cfg, device='cpu')\n"
        "assert torch.equal(forward(back, {'patch_embeds': patches, 'tokens': tok}, cfg), logits)\n"
        "for quantize in (False, True):\n"
        "    eng = repro_torch.ServeEngine(cfg, lm, max_len=24, dtype=torch.bfloat16,\n"
        "                                  quantize=quantize, device='cpu')\n"
        "    out = eng.generate(np.zeros((2, 10), np.int32), 3, extra={'patch_embeds': patches})\n"
        "    assert out.tokens.shape == (2, 3)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_mla_serving_runs_without_jax():
    """Multi-head latent attention (models/attention.py's MLA half), the
    deepseek-v2 config shim, its weights carried out and in, the latent
    cache and int8 serving, with JAX and the reference package
    unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import numpy as np, torch, repro_torch\n"
        "from repro_torch.configs import deepseek_v2_236b\n"
        "from repro_torch.kernels.swa_attention import ops\n"
        "from repro_torch.models import cache_spec, params_from_numpy, params_to_numpy, prefill\n"
        "from repro_torch.models.attention import MLAAttention, attention_apply, mla_apply\n"
        "assert deepseek_v2_236b.CONFIG.mla.kv_lora_rank == 512\n"
        "cfg = repro_torch.get_arch('deepseek-v2').reduced()\n"
        "lm = repro_torch.init_params(cfg, seed=0, dtype=torch.float32, device='cpu')\n"
        "attn = lm.layers[0].attn\n"
        "assert isinstance(attn, MLAAttention)\n"
        "x, pos = torch.randn(2, 6, cfg.d_model), torch.arange(6, dtype=torch.int32)\n"
        "out, cache = mla_apply(attn, x, cfg, pos, return_cache=True)\n"
        "assert out.shape == x.shape and cache['lat'].shape == (2, 6, 40)\n"
        "assert torch.equal(attention_apply(attn, x, cfg, pos)[0], out)\n"
        "q, k, v = (torch.randn(1, 9, 2, n) for n in (192, 192, 128))\n"
        "assert ops.swa_attention(q, k, v, 9).shape == (1, 9, 2, 128)\n"
        "tok = torch.zeros((2, 20), dtype=torch.long)\n"
        "logits, cache = prefill(lm, {'tokens': tok}, cfg)\n"
        "assert cache['lat'].shape == tuple(cache_spec(cfg, 2, 20)['lat'].shape)\n"
        "back = params_from_numpy(params_to_numpy(lm), cfg, device='cpu')\n"
        "assert torch.equal(prefill(back, {'tokens': tok}, cfg)[0], logits)\n"
        "for quantize in (False, True):\n"
        "    eng = repro_torch.ServeEngine(cfg, lm, max_len=24, quantize=quantize, device='cpu')\n"
        "    assert eng.generate(np.zeros((2, 20), np.int32), 3).tokens.shape == (2, 3)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_training_runs_without_jax(tmp_path):
    """The training modules, the pipeline, the cell builders and the train
    command line import and run a reduced step with JAX and the reference package
    unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import math, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from repro_torch import get_arch\n"
        "from repro_torch.data.tokens import SyntheticTokenPipeline\n"
        "from repro_torch.launch import steps, train\n"
        "from repro_torch.models import init_params, trainable\n"
        "from repro_torch.training import (adamw_init, compress_int8, cosine_schedule,\n"
        "                                  make_train_step, named_parameters)\n"
        "cfg = get_arch('qwen3').reduced()\n"
        "pipe = SyntheticTokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4)\n"
        "b = {k: torch.from_numpy(v) for k, v in pipe.host_batch(0).items()}\n"
        "model = trainable(init_params(cfg, seed=0, dtype=torch.float32, device='cpu'))\n"
        "step = make_train_step(cfg, lr_fn=cosine_schedule(1e-3, 1, 4), accum=2, fused_loss=True)\n"
        "_, opt, m = step(model, adamw_init(named_parameters(model)), b)\n"
        "assert math.isfinite(float(m['loss'])) and int(opt.step) == 1\n"
        "assert compress_int8(torch.ones(5))[0].dtype == torch.int8\n"
        "cell = steps.build_cell(cfg, 'train_4k')\n"
        "assert cell.inputs['tokens'].shape == (256, 4096)\n"
        f"loss = train.main(['--arch', 'qwen3', '--reduced', '--steps', '3', '--batch', '2',"
        f" '--seq', '16', '--f32', '--device', 'cpu', '--ckpt-dir', {str(tmp_path)!r}])\n"
        "assert math.isfinite(loss)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_training_entry_points_default_to_the_card(tmp_path):
    """The train command line and a trainable model run on the card unless the
    CPU is asked for: without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    from repro_torch import get_arch
    from repro_torch.launch import train
    from repro_torch.models import init_params, trainable
    from repro_torch.parallel import data_mesh

    cfg = get_arch("qwen3").reduced()
    for call in (lambda: trainable(init_params(cfg)),
                 lambda: train.main(["--arch", "qwen3", "--reduced", "--steps", "1",
                                     "--ckpt-dir", str(tmp_path)]),
                 lambda: data_mesh(1, 0, "file://" + str(tmp_path / "rdv"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not list(tmp_path.iterdir())  # nothing ran: no checkpoint written
