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

    from repro_torch import SeriesFrame, StatPlan, analyze
    from repro_torch.core.backend import get_backend
    from repro_torch.core.plan import autocovariance_request

    x = np.zeros((64, 2), np.float32)
    for call in (lambda: SeriesFrame.from_array(x), lambda: SeriesFrame.from_chunks([x]),
                 lambda: StatPlan([autocovariance_request(2)], d=2),
                 lambda: analyze(x, [autocovariance_request(2)]), lambda: get_backend()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert get_backend(device="cpu").name == "cuda"  # the kernels' plain versions on the CPU
