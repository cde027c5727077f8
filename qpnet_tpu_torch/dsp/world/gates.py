"""The device backend against the host backend on the JAX package's own
device-vs-host gate inputs, with those tests' gates
(tests/test_jax_analysis.py: CheapTrick :28-49, D4C :76-105, the analyzer
:108-134), and the full-size synthetic utterance with the codeap gates held
on it; and the synthesis gates (tests/test_jax_synthesis.py: the periodic
waveform :67-80, the restore pass by MCD :128-186).  One place for the
signals and the gates, which the CPU tests and chip_smoke.py's phases 15
and 16 both hold the device backend to.

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
# synthesis: the deterministic (ap ~ 0) waveform, device against host,
# :78-80; the restore pass's MCD at most the host's own seed-to-seed floor
# plus RESTORE_MCD_MARGIN_DB, its F0 RMSE below RESTORE_F0_RMSE_HZ, :184-186
PERIODIC_CORR_MIN = 0.999
PERIODIC_RMS_MAX = 5e-3                  # rms |d| / rms of the host
RESTORE_MCD_MARGIN_DB = 0.1
RESTORE_F0_RMSE_HZ = 1.0


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
             "codeap_over": lambda v: v < CODEAP_OVER_MAX,
             "syn_corr": lambda v: v > PERIODIC_CORR_MIN,
             "syn_rel_rms": lambda v: v < PERIODIC_RMS_MAX}
    return [f"{k}={m[k]}" for k, ok in gates.items()
            if k in m and not ok(m[k])]


def synthesis_fixture(F: int, fs: int = 22050, shiftms: float = 5.0,
                      voiced_gap: bool = True, half: int = 513):
    """tests/test_jax_synthesis.py's synthesis inputs: (f0, sp), a 150 Hz
    F0 with 3 Hz vibrato (unvoiced over frames F/3 to F/2 with
    voiced_gap) and a smooth two-formant power envelope that drifts over
    the frames (int16-scale power)."""
    t = np.arange(F) * shiftms / 1000.0
    f0 = 150.0 * (1 + 0.08 * np.sin(2 * np.pi * 3.0 * t))
    if voiced_gap:
        f0[F // 3: F // 2] = 0.0
    freqs = np.linspace(0, fs / 2, half)
    base = (1e6 / (1 + ((freqs - 800) / 600) ** 2)
            + 3e5 / (1 + ((freqs - 2400) / 400) ** 2) + 10.0)
    drift = 1.0 + 0.3 * np.sin(np.linspace(0, 3.0, F))
    return f0, base[None, :] * drift[:, None]


def restore_features(F: int, fs: int = 22050, dim: int = 34,
                     alpha: float = 0.455) -> dict:
    """The feature sets of tests/test_jax_synthesis.py:146-158 (the restore
    worker's gate): the fixture's voiced F0 and envelope as /world (uv,
    F0, mcep, codeap of ap = 1e-6) and /f0."""
    from qpnet_tpu_torch.dsp.mcep import sp2mc
    from qpnet_tpu_torch.dsp.world.codec import code_aperiodicity
    f0, sp = synthesis_fixture(F, fs, voiced_gap=False)
    mcep = sp2mc(sp, dim, alpha)
    codeap = code_aperiodicity(np.full_like(sp, 1e-6), fs)
    world = np.concatenate([(f0 > 0).astype(np.float64)[:, None],
                            f0[:, None], mcep, codeap], axis=1)
    return {"/world": world.astype(np.float32), "/f0": f0}


def restore_floor(world: np.ndarray, f0: np.ndarray, fs: int,
                  fftl: int = 1024, alpha: float = 0.455, dim: int = 34,
                  **kw) -> dict:
    """The restore gate's floor: wav_metrics of the host synthesis against
    itself at seeds 1 and 2, from the restore pass's inputs."""
    from qpnet_tpu_torch.dsp.mcep import mc2sp
    from qpnet_tpu_torch.dsp.world.codec import decode_aperiodicity
    from qpnet_tpu_torch.dsp.world.synthesis import synthesize
    from qpnet_tpu_torch.tools.evaluate import wav_metrics
    sp = mc2sp(np.asarray(world[:, 2: 3 + dim], np.float64), alpha, fftl)
    ap = decode_aperiodicity(np.asarray(world[:, 3 + dim:], np.float64), fs,
                             fftl)
    ya, yb = (synthesize(f0, sp, ap, fs, seed=s) for s in (1, 2))
    return wav_metrics(ya, yb, fs, dim, alpha, **kw)


def periodic_metrics(y_host, y_dev) -> dict:
    """The deterministic synthesis, device against host: correlation and
    rms |d| over the host's rms."""
    y_host, y_dev = np.asarray(y_host, np.float64), np.asarray(y_dev,
                                                               np.float64)
    rms = np.sqrt(np.mean(y_host ** 2))
    return {"syn_corr": float(np.corrcoef(y_host, y_dev)[0, 1]),
            "syn_rel_rms": float(np.sqrt(np.mean((y_host - y_dev) ** 2))
                                 / rms)}
