"""WORLD synthesis: f0 + spectral envelope + aperiodicity -> waveform; the
port's copy of `qpnet_tpu/dsp/world/synthesis.py`, float64 numpy with
`default_rng(seed)`, bit-equal to it.

Pitch-synchronous overlap-add with WORLD's excitation construction (the
reference reaches this algorithm through sprocket/pyworld,
reference src/bin/feature_extract.py:215-274):

  * pulse positions come from the phase wraps of the sample-interpolated
    F0 track (unvoiced regions tick at DEFAULT_F0); each pulse carries a
    FRACTIONAL time offset — the sub-sample zero-crossing position of the
    wrapped phase — applied to the periodic response as a spectral phase
    ramp exp(-j w tau), not by rounding to the nearest sample;
  * per pulse, the periodic response is the minimum-phase impulse
    response of sqrt(sp * (1-ap^2)), phase-shifted by the fractional
    offset, high-pass corrected by a Hann-shaped DC remover, and scaled
    by sqrt(pulse interval) (line-spectrum energy normalization);
  * the aperiodic response is a ZERO-MEAN white-noise burst of one pulse
    interval filtered by the minimum-phase response of sqrt(sp * ap^2)
    (the full envelope when unvoiced);
  * a pulse whose aperiodicity ratio saturates at the DC bin (> 0.999)
    is treated as noise-only, as WORLD does;
  * responses overlap-add at the integer pulse positions (the fractional
    part lives in the phase ramp).

"""

from __future__ import annotations

import numpy as np

from qpnet_tpu_torch.dsp.world.common import minimum_phase_spectrum, safe_log

DEFAULT_F0 = 500.0


def _pulse_times(f0: np.ndarray, time_axis: np.ndarray, fs: int,
                 n_samples: int):
    """Excitation pulses from the wrapped phase of the interpolated F0.

    Returns (integer sample indices, fractional time shifts in seconds,
    voicing flag per pulse).  The fractional shift is the sub-sample
    position where the wrapped phase crosses zero between index i and
    i+1 (linear interpolation of the crossing), so pulse k really sits at
    (idx[k] + shift[k]*fs)/fs — the shift is applied spectrally."""
    t = np.arange(n_samples) / fs
    f0_interp = np.interp(t, time_axis, np.where(f0 > 0, f0, 0.0))
    voiced_interp = np.interp(t, time_axis, (f0 > 0).astype(np.float64)) > 0.5
    inst = np.where(voiced_interp & (f0_interp > 0), f0_interp, DEFAULT_F0)
    phase = np.cumsum(2 * np.pi * inst / fs)
    wrapped = phase % (2 * np.pi)
    cross = np.abs(np.diff(wrapped)) > np.pi      # wrap between i and i+1
    idx = np.where(cross)[0]
    y1 = wrapped[idx] - 2 * np.pi                 # negative side
    y2 = wrapped[idx + 1]                         # positive side
    frac = -y1 / np.maximum(y2 - y1, 1e-12)       # in (0, 1]
    shift = frac / fs
    voiced_p = voiced_interp[idx]
    if len(idx) == 0 or idx[0] != 0:
        # deliberate deviation from WORLD: the phase accumulator starts at
        # ~0, so the first wrap (and hence the first excitation) falls one
        # full period into the signal — real recordings open with silence
        # and never show it, but synthetic fixtures and feature-driven
        # synthesis would lose their first pitch period (measured: frames
        # 0-1 at 3-5 dB MCD without this pulse).
        idx = np.concatenate([[0], idx])
        shift = np.concatenate([[0.0], shift])
        voiced_p = np.concatenate([[voiced_interp[0]], voiced_p])
    return idx, shift, voiced_p


def _frame_interp(arr: np.ndarray, time_axis: np.ndarray, t: float
                  ) -> np.ndarray:
    """Linear interpolation of per-frame spectra at time t (pulse-time
    envelope interpolation removes frame-boundary steps)."""
    F = arr.shape[0]
    pos = t / (time_axis[1] - time_axis[0]) if F > 1 else 0.0
    i0 = int(np.floor(pos))
    if i0 >= F - 1:
        return arr[F - 1]
    if i0 < 0:
        return arr[0]
    w = pos - i0
    return (1.0 - w) * arr[i0] + w * arr[i0 + 1]


def _dc_remover(fftl: int) -> np.ndarray:
    """Hann-shaped window normalized so that adding
    `sum(response) * dc_remover` cancels the response's DC component
    (WORLD's GetDCRemover)."""
    half = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(1, fftl // 2 + 1)
                              / (fftl + 1))
    w = np.concatenate([half, half[::-1]])
    return -w / w.sum()


def synthesize(f0: np.ndarray, spectrogram: np.ndarray,
               aperiodicity: np.ndarray, fs: int,
               frame_period: float = 5.0, seed: int = 0) -> np.ndarray:
    """Returns float64 waveform of length n_frames * frame_period * fs/1000."""
    f0 = np.asarray(f0, np.float64)
    sp = np.asarray(spectrogram, np.float64)
    ap = np.asarray(aperiodicity, np.float64)
    F, half = sp.shape
    fftl = (half - 1) * 2
    time_axis = np.arange(F) * frame_period / 1000.0
    n_samples = int(F * frame_period / 1000.0 * fs)
    rng = np.random.default_rng(seed)

    pulses, time_shift, voiced = _pulse_times(f0, time_axis, fs, n_samples)
    out = np.zeros(n_samples + 2 * fftl)
    dc_rem = _dc_remover(fftl)
    bin_idx = np.arange(half)

    for k, p in enumerate(pulses):
        interval = (pulses[k + 1] - p) if k + 1 < len(pulses) else \
            (pulses[k] - pulses[k - 1] if k > 0 else fftl)
        interval = max(int(interval), 1)
        t_pulse = p / fs
        frame_sp = np.maximum(_frame_interp(sp, time_axis, t_pulse), 1e-300)
        frame_ap = np.clip(_frame_interp(ap, time_axis, t_pulse),
                           1e-12, 1 - 1e-12)
        ap_ratio = frame_ap ** 2
        # noise-only when the DC-bin aperiodicity saturates (WORLD's
        # GetPeriodicResponse gate; the Nyquist bin is ~1 by construction
        # in decoded aperiodicity, so it must NOT be the gate)
        if voiced[k] and ap_ratio[0] <= 0.999:
            per_pow = frame_sp * (1.0 - ap_ratio)
            mp = minimum_phase_spectrum(0.5 * safe_log(per_pow))
            # fractional pulse position: delay the periodic response by
            # tau seconds as a phase ramp (WORLD's
            # GetSpectrumWithFractionalTimeShift)
            coeff = 2.0 * np.pi * time_shift[k] * fs / fftl
            ir = np.fft.irfft(mp * np.exp(-1j * coeff * bin_idx), fftl)
            ir += ir.sum() * dc_rem
            out[p: p + fftl] += ir * np.sqrt(interval)
            noise_pow = frame_sp * ap_ratio
        else:
            noise_pow = frame_sp
        mpn = minimum_phase_spectrum(0.5 * safe_log(np.maximum(noise_pow,
                                                               1e-300)))
        noise = rng.standard_normal(interval)
        noise -= noise.mean()                    # zero-mean burst (WORLD)
        burst = np.fft.irfft(np.fft.rfft(noise, fftl) * mpn, fftl)
        out[p: p + fftl] += burst

    return out[:n_samples]
