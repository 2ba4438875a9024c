"""The port stands alone: no JAX, nothing of `repro`, and the card unless
the CPU is asked for."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


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


def test_no_source_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b|import repro\.|from repro[. ])",
                         re.M)
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    import numpy as np

    from repro_torch import BandedARModel, ServeEngine, SeriesFrame, StatPlan, analyze, get_arch
    from repro_torch.core.backend import get_backend
    from repro_torch.core.estimators.spectral import hann_window, welch_chunk_kernel
    from repro_torch.core.plan import autocovariance_request
    from repro_torch.launch import serve
    from repro_torch.models import init_params, params_from_numpy, params_to_numpy

    x = np.zeros((64, 2), np.float32)
    cfg = get_arch("danube").reduced()
    cpu_model = init_params(cfg, device="cpu")
    tree = params_to_numpy(cpu_model)
    for call in (lambda: SeriesFrame.from_array(x), lambda: SeriesFrame.from_chunks([x]),
                 lambda: StatPlan([autocovariance_request(2)], d=2),
                 lambda: analyze(x, [autocovariance_request(2)]), lambda: get_backend(),
                 lambda: BandedARModel.from_numpy(np.zeros((4, 3))), lambda: hann_window(8),
                 lambda: welch_chunk_kernel(8, 4, 1.0, get_backend(device="cpu")),
                 lambda: init_params(cfg), lambda: params_from_numpy(tree, cfg),
                 lambda: ServeEngine(cfg, cpu_model, max_len=8),
                 lambda: serve.main(["--arch", "danube", "--reduced"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert get_backend(device="cpu").name == "cuda"  # the kernels' plain versions on the CPU
