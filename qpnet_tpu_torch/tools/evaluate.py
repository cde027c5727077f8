"""Objective evaluation between waveforms: MCD, F0 RMSE and V/UV error,
the port's copy of `qpnet_tpu/tools/evaluate.py`.  So far `wav_metrics`,
which the synthesis gates use; `evaluate_pairs` and the CLI are not
ported yet (ROADMAP.md, Queue 1).

MCD convention: (10*sqrt(2)/ln10) * mean ||mc_a[1:] - mc_b[1:]||_2 over
frames voiced in both signals (c0 excluded), the shorter length aligned.
"""

from __future__ import annotations

import numpy as np

MCD_K = 10.0 * np.sqrt(2.0) / np.log(10.0)


def wav_metrics(x_ref, x_gen, fs: int, mcep_dim: int = 34,
                alpha: float = 0.455, minf0: float = 40.0,
                maxf0: float = 800.0) -> dict:
    """MCD (dB, c0 excluded, frames voiced in both) and F0 RMSE of x_gen
    against x_ref by the host analysis, and the V/UV disagreement rate."""
    from qpnet_tpu_torch.dsp.world.api import WorldAnalyzer

    an = WorldAnalyzer(fs=fs, minf0=minf0, maxf0=maxf0)
    f0_a, _, _ = an.analyze(np.asarray(x_ref, np.float64))
    mc_a = an.mcep(dim=mcep_dim, alpha=alpha)
    f0_b, _, _ = an.analyze(np.asarray(x_gen, np.float64))
    mc_b = an.mcep(dim=mcep_dim, alpha=alpha)
    F = min(len(f0_a), len(f0_b))
    f0_a, f0_b, mc_a, mc_b = f0_a[:F], f0_b[:F], mc_a[:F], mc_b[:F]
    both = (f0_a > 0) & (f0_b > 0)
    out = {"frames": int(F), "voiced_both": int(both.sum()),
           "mcd_db": float("nan"), "f0_rmse_hz": float("nan"),
           "vuv_error_rate": float(np.mean((f0_a > 0) != (f0_b > 0)))}
    if both.any():
        diff = mc_a[both, 1:] - mc_b[both, 1:]
        out["mcd_db"] = float(MCD_K * np.mean(np.sqrt(np.sum(diff ** 2, 1))))
        out["f0_rmse_hz"] = float(np.sqrt(np.mean(
            (f0_a[both] - f0_b[both]) ** 2)))
    return out
