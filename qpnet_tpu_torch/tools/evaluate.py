"""Objective evaluation between waveforms: MCD, F0 RMSE and V/UV error,
the port's copy of `qpnet_tpu/tools/evaluate.py` (the same JSON for the
same wavs; the host WORLD analysis, float64).

  python -m qpnet_tpu_torch.tools.evaluate --ref_wavs <dir|list> \
      --gen_wavs <dir|list>      # pairs matched by basename

MCD convention: (10*sqrt(2)/ln10) * mean ||mc_a[1:] - mc_b[1:]||_2 over
frames voiced in both signals (c0 excluded), the shorter length aligned.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Sequence

import numpy as np
from scipy.io import wavfile

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


def evaluate_pairs(ref_paths: Sequence[str], gen_paths: Sequence[str],
                   **kw) -> Dict:
    """`wav_metrics` of each (reference, generated) wav pair and their
    means over the pairs with finite values."""
    per_utt = []
    for rp, gp in zip(ref_paths, gen_paths):
        fs_a, xa = wavfile.read(rp)
        fs_b, xb = wavfile.read(gp)
        if fs_a != fs_b:
            raise ValueError(f"{rp} at {fs_a} Hz, {gp} at {fs_b} Hz")
        m = wav_metrics(xa.astype(np.float64), xb.astype(np.float64),
                        fs_a, **kw)
        m["ref"] = os.path.basename(rp)
        per_utt.append(m)
    mcds = [m["mcd_db"] for m in per_utt if np.isfinite(m["mcd_db"])]
    f0s = [m["f0_rmse_hz"] for m in per_utt if np.isfinite(m["f0_rmse_hz"])]
    return {
        "n_utterances": len(per_utt),
        "mcd_db_mean": float(np.mean(mcds)) if mcds else float("nan"),
        "f0_rmse_hz_mean": float(np.mean(f0s)) if f0s else float("nan"),
        "vuv_error_rate_mean": float(np.mean(
            [m["vuv_error_rate"] for m in per_utt])),
        "per_utterance": per_utt,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="MCD / F0-RMSE evaluation")
    p.add_argument("--ref_wavs", required=True,
                   help="list file or directory of reference wavs")
    p.add_argument("--gen_wavs", required=True,
                   help="list file or directory of generated wavs "
                        "(matched by basename)")
    p.add_argument("--mcep_dim", type=int, default=34)
    p.add_argument("--mcep_alpha", type=float, default=0.455)
    p.add_argument("--minf0", type=float, default=40.0)
    p.add_argument("--maxf0", type=float, default=800.0)
    args = p.parse_args(argv)

    from qpnet_tpu_torch.data import find_files, read_txt

    def resolve(path):
        if os.path.isdir(path):
            return sorted(find_files(path, "*.wav"))
        return read_txt(path)

    refs = resolve(args.ref_wavs)
    gens = {os.path.basename(g): g for g in resolve(args.gen_wavs)}
    pairs = [(r, gens[os.path.basename(r)]) for r in refs
             if os.path.basename(r) in gens]
    result = evaluate_pairs(
        [r for r, _ in pairs], [g for _, g in pairs],
        mcep_dim=args.mcep_dim, alpha=args.mcep_alpha,
        minf0=args.minf0, maxf0=args.maxf0)
    result.pop("per_utterance")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
