"""The device backend against the host backend on the JAX package's own
device-vs-host gate inputs, with those tests' gates
(tests/test_jax_analysis.py: CheapTrick :28-49, D4C :76-105, the analyzer
:108-134), and the full-size synthetic utterance with the codeap gates held
on it.  One place for the signals and the gates, which the CPU tests and
chip_smoke.py's phase 15 both hold the device backend to.

    m = gate_metrics("cuda", d4c_fs=22050)
    assert not gate_failures(m), gate_failures(m)
"""

from __future__ import annotations

import numpy as np

CT_MEDIAN_DB, CT_MEAN_DB = 0.01, 0.05   # CheapTrick |d| in dB, :48-49
D4C_MAX_DB = 0.05                        # D4C max |d| in dB, :102
MCEP_C0_MAX, MCEP_MEAN_MAX = 0.1, 0.05   # mcep c0 / all, mean |d|, :131-132
CODEAP_MAX_DB = 0.1                      # codeap max |d| in dB, :134
# On full-size voiced utterances float32 D4C, the JAX package's device
# path as well as the port's, puts a few codeap values beyond
# CODEAP_MAX_DB of the float64 host, at the same places
# (tests/test_torch_port_dsp_fullsize.py); there codeap is held to a
# median and to the share of values beyond CODEAP_MAX_DB.
CODEAP_MEDIAN_DB = 0.01
CODEAP_OVER_MAX = 0.01


def db(a, scale: float = 10.0) -> np.ndarray:
    return scale * np.log10(np.maximum(a, 1e-30))


def voiced_utterance(rng, seconds: float, fs: int = 22050) -> np.ndarray:
    """A synthetic voiced utterance at int16 scale: silence, a voiced
    span, a fricative-like noise burst, a second voiced span, silence.  F0
    glides over about 100-180 Hz with a 5.5 Hz vibrato; the harmonics are
    shaped by three formants and a -6 dB/octave tilt."""
    n = int(seconds * fs)
    t = np.arange(n) / fs
    f0 = (140.0 + 35.0 * np.sin(2 * np.pi * 0.4 * t + rng.uniform(0, 6))
          + 4.0 * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    voiced = np.zeros(n)
    for k in range(1, 41):
        fk = k * f0
        env = sum(np.exp(-((fk - fc) / bw) ** 2)
                  for fc, bw in ((700, 300), (1200, 400), (2600, 600)))
        voiced += np.where(fk < fs / 2, (0.3 + env) / k, 0.0) * np.sin(
            k * phase + rng.uniform(0, 6))
    gate = np.zeros(n)
    sil, unv0 = int(0.1 * fs), int(0.45 * n)
    unv1 = unv0 + int(0.1 * fs)
    gate[sil:unv0] = gate[unv1:n - sil] = 1.0
    gate = np.convolve(gate, np.hanning(int(0.01 * fs)), "same")
    gate /= gate.max()
    noise = np.diff(rng.normal(size=n + 1))
    burst = np.zeros(n)
    burst[unv0:unv1] = 0.15 * noise[unv0:unv1]
    x = voiced / np.abs(voiced).max() * gate + burst
    return 12000.0 * x / np.abs(x).max() + 3.0 * rng.normal(size=n)


def codeap_full_metrics(ca_host, ca_dev) -> dict:
    """codeap |d| of a device backend against the host on a full-size
    utterance: median, max and the share beyond CODEAP_MAX_DB."""
    ca = np.abs(np.asarray(ca_host) - np.asarray(ca_dev))
    return {"codeap_median_db": float(np.median(ca)),
            "codeap_max_db": float(ca.max()),
            "codeap_over": float((ca > CODEAP_MAX_DB).mean()),
            "codeap_n_over": int((ca > CODEAP_MAX_DB).sum())}


def cheaptrick_metrics(device, fs: int = 16000) -> dict:
    """A 130 Hz harmonic tone of 0.4 s, the same F0 and time axis in both:
    |d| in dB above a -90 dB relative floor, away from the edges."""
    from qpnet_tpu_torch.dsp.world.cheaptrick import cheaptrick
    from qpnet_tpu_torch.dsp.world.device_analysis import device_cheaptrick

    n = int(0.4 * fs)
    t = np.arange(n) / fs
    x = sum(0.8 ** k * np.sin(2 * np.pi * 130.0 * (k + 1) * t)
            for k in range(12)) * 4000
    F = int(n / (fs * 0.005)) + 1
    f0 = np.full(F, 130.0)
    ta = np.arange(F) * 0.005
    ref = cheaptrick(x, f0, ta, fs, fft_size=1024)
    got = device_cheaptrick(x, f0, ta, fs, fft_size=1024,
                            device=device).cpu().numpy()
    floor = ref.max() * 1e-9
    err = np.abs(db(np.maximum(ref[4:-4], floor))
                 - db(np.maximum(got[4:-4], floor)))
    return {"ct_median_db": float(np.median(err)),
            "ct_mean_db": float(err.mean())}


def d4c_metrics(device, fs: int) -> dict:
    """A 1 s vibrato harmonic signal with noise and an unvoiced head: max
    |d| in dB and whether the voicing decisions (bin 100 > 0.99) agree."""
    from qpnet_tpu_torch.dsp.world.d4c import d4c
    from qpnet_tpu_torch.dsp.world.device_analysis import device_d4c

    rng = np.random.default_rng(0)
    t = np.arange(fs) / fs
    f0c = 160 + 40 * np.sin(2 * np.pi * 1.1 * t)
    ph = 2 * np.pi * np.cumsum(f0c) / fs
    x = sum(a * np.sin(k * ph)
            for k, a in [(1, .5), (2, .3), (3, .15), (4, .1), (6, .05)])
    x += 0.03 * rng.normal(size=fs)
    x[: fs // 8] = 0.05 * rng.normal(size=fs // 8)
    ta = np.arange(0, 0.995, 0.005)
    f0 = f0c[(ta * fs).astype(int)].copy()
    f0[: len(ta) // 8] = 0.0
    ap_h = d4c(x, f0, ta, fs)
    ap_d = device_d4c(x, f0, ta, fs, device=device).cpu().numpy()
    return {"d4c_max_db": float(np.abs(db(ap_h, 20) - db(ap_d, 20)).max()),
            "d4c_same_voicing": bool(np.array_equal(ap_h[:, 100] > 0.99,
                                                    ap_d[:, 100] > 0.99))}


def analyzer_metrics(device, fs: int = 16000) -> dict:
    """WorldAnalyzer's two backends on a gliding sawtooth of 0.6 s, the
    host F0 in both: F0 equal, mcep (24, alpha 0.41) and codeap |d|."""
    from qpnet_tpu_torch.dsp.world.api import WorldAnalyzer

    rng = np.random.default_rng(5)
    n = int(0.6 * fs)
    ph = np.cumsum(np.linspace(120, 180, n) / fs)
    x = (0.5 * (2 * (ph % 1.0) - 1.0) + 0.01 * rng.normal(size=n)) * 12000
    feats = {}
    for backend in ("numpy", "jax"):
        an = WorldAnalyzer(fs=fs, minf0=60, maxf0=400, backend=backend,
                           device=device)
        f0, _, _ = an.analyze(x)
        feats[backend] = (f0, an.mcep(dim=24, alpha=0.41), an.codeap())
    (f0_n, mc_n, ca_n), (f0_j, mc_j, ca_j) = feats["numpy"], feats["jax"]
    same = mc_n.shape == mc_j.shape
    return {"an_f0_equal": bool(np.array_equal(f0_n, f0_j)),
            "an_mcep_shape_equal": same,
            "an_mcep_c0_mean": float(np.abs(mc_n[:, 0] - mc_j[:, 0]).mean())
            if same else float("inf"),
            "an_mcep_mean": float(np.abs(mc_n - mc_j).mean())
            if same else float("inf"),
            "an_codeap_max_db": float(np.abs(ca_n - ca_j).max())}


def gate_metrics(device, d4c_fs: int, fs: int = 16000) -> dict:
    """Every metric above: CheapTrick and the analyzer at `fs`, D4C at
    `d4c_fs` (the JAX test's own rate is 22,050 Hz)."""
    return {**cheaptrick_metrics(device, fs), **d4c_metrics(device, d4c_fs),
            **analyzer_metrics(device, fs)}


def gate_failures(m: dict) -> list:
    """The gates that the metrics `m` (any subset of gate_metrics' and
    codeap_full_metrics') miss."""
    gates = {"ct_median_db": lambda v: v < CT_MEDIAN_DB,
             "ct_mean_db": lambda v: v < CT_MEAN_DB,
             "d4c_max_db": lambda v: v < D4C_MAX_DB,
             "d4c_same_voicing": bool,
             "an_f0_equal": bool,
             "an_mcep_shape_equal": bool,
             "an_mcep_c0_mean": lambda v: v < MCEP_C0_MAX,
             "an_mcep_mean": lambda v: v < MCEP_MEAN_MAX,
             "an_codeap_max_db": lambda v: v < CODEAP_MAX_DB,
             "codeap_median_db": lambda v: v <= CODEAP_MEDIAN_DB,
             "codeap_over": lambda v: v < CODEAP_OVER_MAX}
    return [f"{k}={m[k]}" for k, ok in gates.items()
            if k in m and not ok(m[k])]
