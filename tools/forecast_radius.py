#!/usr/bin/env python3
"""Spectral radius of the MA part that ARMA(2, 1) fits on the smoke run's
kinds of series, on the CPU (plain versions).

Above 1 the innovations filter behind an ``arma`` forecast and anomaly
member diverges: its residuals overflow on every path, the reference's
too.  Two sets of series:

  * ``chip_smoke.make_series`` at d = 64, 2^18 samples (the store phase's
    kind of series), fitted with recursion depth m in (3, 6, 10, 16);
  * six d = 16 tenants of 2,048 samples: a stable AR(1) per channel (phi
    uniform in [0.3, 0.9]), a sinusoid at bin k = 4..9 of a 64-point
    segment, white noise (the gateway phase's kind of series), m in (3,
    16), with the period the ``auto`` member detects beside round(64 / k).

    PYTHONPATH=src python3 tools/forecast_radius.py      # ~1 minute, prints JSON
"""
import json
import math
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> None:
    import chip_smoke
    from repro_torch import SeriesFrame

    out = {"d64": {}, "d16": []}
    x = chip_smoke.make_series(1 << 18, 64, 0, torch.device("cpu"))
    for m in (3, 6, 10, 16):
        frame = SeriesFrame.from_array(x, device="cpu")
        frame.moments(128)
        frame.anomaly_scores("arma", p=2, q=1, m=m)
        frame.collect()
        out["d64"][m] = chip_smoke.ma_radius(frame, "anomaly")
    g = torch.Generator().manual_seed(0)
    for i in range(6):
        k = 4 + i
        phi = 0.3 + 0.6 * torch.rand(16, generator=g)
        e = torch.randn(2048, 16, generator=g)
        y = torch.zeros_like(e)
        for t in range(1, 2048):
            y[t] = phi * y[t - 1] + e[t]
        t = torch.arange(2048).float()
        y = y + torch.sin(2 * math.pi * k * t / 64)[:, None] + 0.5 * torch.randn(2048, 16,
                                                                                 generator=g)
        row = {"bin": k, "planted_period": round(64 / k)}
        for m in (3, 16):
            frame = SeriesFrame.from_array(y, device="cpu")
            frame.moments(128)
            frame.welch(64, 32)
            frame.anomaly_scores("arma", p=2, q=1, m=m)
            frame.forecast(16, "auto", p=4, max_period=16)
            res = frame.collect()
            row[f"radius_m{m}"] = chip_smoke.ma_radius(frame, "anomaly")
            row["detected_period"] = int(res["forecast"]["period"])
        out["d16"].append(row)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
