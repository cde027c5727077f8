"""Device WORLD analysis in plain PyTorch: CheapTrick, D4C, mel-cepstrum and
the fused per-utterance pass.

The port of `qpnet_tpu/dsp/world/jax_analysis.py`, float32 on the device
the input tensors lie on.  Per-frame work is batched over frames instead of
vmapped: each stage gathers its pitch-adaptive windows as one (F, slot)
tensor from index arithmetic (the window functions are zero outside their
per-frame support, so a fixed slot is exact), then runs one batched
`torch.fft.rfft`.  The f0-adaptive fractional-box smoothing is a sum over
static offsets with per-frame overlap weights (kernel W4 of
`ops/world_kernel.py` on the card).

Constants that the host computes (the D4C band window, the anchor
interpolation, the freqt matrix) are cached on the device, so a call
uploads nothing but its inputs and queues its work without waiting for
the device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from qpnet_tpu_torch.dsp.mcep import freqt
from qpnet_tpu_torch.dsp.world.cheaptrick import DEFAULT_F0, Q1
from qpnet_tpu_torch.dsp.world.codec import band_frequencies
from qpnet_tpu_torch.dsp.world.common import nuttall
from qpnet_tpu_torch.dsp.world.d4c import (FLOOR_F0_D4C,
                                           LOVE_TRAIN_LOWEST_F0, UNVOICED_AP)
from qpnet_tpu_torch.dsp.world.device_f0 import (as_signal, device_harvest,
                                                 device_dio, device_stonemask,
                                                 frame_axis, mark, rdiv)
from qpnet_tpu_torch.ops import world_kernel


def _linear_smoothing(spec, width_hz, fs: int, fft_size: int, kmax: int):
    """Vectorized common.linear_smoothing: per-frame fractional-box
    convolution of width width_hz (F,), mirror-extended at the edges; the
    sum over the 2*kmax offsets is kernel W4."""
    bin_hz = fs / fft_size
    ext = torch.cat([spec[:, 1: kmax + 1].flip(1), spec,
                     spec[:, -kmax - 1: -1].flip(1)], dim=1)
    w_bins = width_hz / bin_hz
    lo, hi = -w_bins / 2.0, w_bins / 2.0
    offsets = torch.arange(-kmax, kmax, dtype=torch.float32,
                           device=spec.device)
    ov = torch.clamp(torch.minimum(hi[:, None], offsets[None, :] + 1)
                     - torch.maximum(lo[:, None], offsets[None, :]), min=0.0)
    ov = ov / torch.sum(ov, dim=1, keepdim=True)
    return world_kernel.smooth(ext, ov)


def _dc_correct(spec, cf0, fs: int, fft_size: int, jmax: int):
    """Vectorized common.dc_correction over frames: bins below f0 of
    spec (F, half+1) receive += interp(spec, f0 - f)."""
    halfp1 = spec.shape[1]
    j = torch.arange(jmax, device=spec.device)
    src = cf0[:, None] * fft_size / fs - j[None, :]
    i0 = torch.floor(src).long().clamp(0, halfp1 - 2)
    frac = src - i0
    add = (torch.gather(spec, 1, i0) * (1.0 - frac)
           + torch.gather(spec, 1, i0 + 1) * frac)
    n_rep = 1 + (cf0 * fft_size / fs).to(torch.int32)   # upper_limit - 1
    add = torch.where(j[None, :] < n_rep[:, None], add, 0.0)
    return torch.cat([spec[:, :jmax] + add, spec[:, jmax:]], dim=1)


def device_cheaptrick(x, f0, time_axis, fs: int, fft_size: int = 1024,
                      f0_floor: float = 71.0, f0_ceil: float = 800.0,
                      n_valid=None, device="cuda") -> torch.Tensor:
    """CheapTrick spectral envelope batched over frames, the port of
    jax_analysis.jax_cheaptrick.

    x: (n,) waveform;  f0/time_axis: (F,).  f0_ceil sizes the
    DC-correction and smoothing windows; n_valid: true signal length when x
    is padded to a bucketed length (samples at index >= n_valid are outside
    the signal).  Returns (F, fft_size//2+1) power spectrogram."""
    x = as_signal(x, device)
    dev = x.device
    f0 = as_signal(f0, dev)
    time_axis = as_signal(time_axis, dev)
    n_valid = x.shape[0] if n_valid is None else n_valid
    half = fft_size // 2
    ceil_f0 = max(float(f0_ceil), DEFAULT_F0)
    cf0 = torch.where(f0 > f0_floor / 2, f0, DEFAULT_F0)
    # WORLD's fit guarantee: below f0_low_limit the 3-period window cannot
    # fit fft_size -> default F0, like the host path
    f0_low_limit = 3.0 * fs / (fft_size - 3.0)
    cf0 = torch.where(cf0 < f0_low_limit, DEFAULT_F0, cf0)
    max_hw = (fft_size - 3) // 2
    centers = torch.round(time_axis * fs).long()

    # cheaptrick._windowed_power_spectrum for every frame: the window spans
    # +-round(1.5*fs/f0) samples, out-of-signal samples are zero-filled,
    # the window-weighted mean is removed, energy-normalized by sum(w^2)
    base = torch.arange(-max_hw, max_hw + 1, device=dev)
    half_w = torch.floor(rdiv(1.5 * fs, cf0) + 0.5).long()
    mask = torch.abs(base)[None, :] <= half_w[:, None]  # (F, W)
    idx = centers[:, None] + base[None, :]
    seg = torch.where((idx >= 0) & (idx < n_valid) & mask,
                      x[idx.clamp(0, x.shape[0] - 1)], 0.0)
    w = torch.where(mask, 0.5 + 0.5 * torch.cos(
        math.pi * (base / fs)[None, :] * cf0[:, None] / 1.5), 0.0)
    windowed = seg * w
    windowed = windowed - w * (torch.sum(windowed, 1, keepdim=True)
                               / torch.sum(w, 1, keepdim=True))
    windowed = windowed / torch.sqrt(torch.sum(w ** 2, 1, keepdim=True))
    ps = torch.abs(torch.fft.rfft(windowed, fft_size, dim=1)) ** 2

    # mirror sub-f0 bins (WORLD DCCorrection); window sizes cover ceil_f0
    jmax = min(2 + int(ceil_f0 * fft_size / fs) + 2, half)
    ps = _dc_correct(ps, cf0, fs, fft_size, jmax)

    # f0-adaptive fractional box smoothing over width 2*f0/3
    K = int(np.ceil((2.0 * ceil_f0 / 3.0) / (fs / fft_size) / 2)) + 2
    sm = _linear_smoothing(ps, 2.0 * cf0 / 3.0, fs, fft_size, K)
    sm = sm.clamp_min(1e-30)

    # liftering in the cepstral domain
    c = torch.fft.irfft(torch.log(sm), n=fft_size, dim=1)
    tau_idx = torch.arange(fft_size, device=dev)
    tau = torch.minimum(tau_idx, fft_size - tau_idx) / fs
    arg = math.pi * cf0[:, None] * tau[None, :]
    smooth = torch.where(arg == 0, 1.0, torch.sin(arg.clamp_min(1e-30))
                         / arg.clamp_min(1e-30))
    q0 = 1.0 - 2.0 * Q1
    recover = q0 + 2.0 * Q1 * torch.cos(2 * math.pi * cf0[:, None] * tau)
    log_ps = torch.fft.rfft(c * smooth * recover, dim=1).real
    return torch.exp(log_ps)


@functools.lru_cache(maxsize=8)
def _d4c_static(fs: int, fft_size: int, device: torch.device):
    """Shape-defining constants of D4C for a given fs (jax_analysis.
    _d4c_static), with the band window and the anchor interpolation on the
    device."""
    fft_d4c = 1 << (1 + int(np.log2(4.0 * fs / FLOOR_F0_D4C + 1)))
    fft_lt = 1 << (1 + int(np.log2(3.0 * fs / LOVE_TRAIN_LOWEST_F0 + 1)))
    bands = band_frequencies(fs)
    window_length = int(3000.0 * fft_d4c / fs) * 2 + 2
    half_out = fft_size // 2 + 1
    half_d4c = fft_d4c // 2
    c = {
        "fft_d4c": fft_d4c,
        "half_d4c": half_d4c,
        # max half-window: ratio=4 periods at the 47 Hz D4C floor
        "max_hw": int(np.floor(2.0 * fs / FLOOR_F0_D4C + 0.5)),
        "fft_lt": fft_lt,
        "max_hw_lt": int(np.floor(1.5 * fs / LOVE_TRAIN_LOWEST_F0 + 0.5)),
        "n_bands": len(bands),
        "window": torch.as_tensor(nuttall(window_length).astype(np.float32),
                                  device=device),
        "boundary": int(np.floor(fft_d4c * 8.0 / window_length + 0.5)),
        "b0": int(np.ceil(100.0 * fft_lt / fs)),
        "b1": int(np.ceil(4000.0 * fft_lt / fs)),
        "b2": min(int(np.ceil(7900.0 * fft_lt / fs)), fft_lt // 2),
    }
    assert 2 * c["max_hw"] + 1 <= fft_d4c
    assert 2 * c["max_hw_lt"] + 1 <= fft_lt
    # each band's segment of the group delay: indices and validity
    hw = window_length // 2
    band_idx, band_ok = [], []
    for i in range(len(bands)):
        center = int(3000.0 * (i + 1) * fft_d4c / fs)
        idx = np.arange(center - hw, center - hw + window_length)
        band_ok.append((idx >= 0) & (idx <= half_d4c))
        band_idx.append(np.clip(idx, 0, half_d4c))
    c["band_idx"] = torch.as_tensor(np.array(band_idx, np.int64),
                                    device=device)
    c["band_ok"] = torch.as_tensor(np.array(band_ok, bool), device=device)
    # interpolation of the band anchors over the output spectrum
    anchors_f = np.concatenate([[0.0], bands, [fs / 2.0]])
    freqs_out = np.arange(half_out) * fs / fft_size
    si = np.clip(np.searchsorted(anchors_f, freqs_out, side="right") - 1,
                 0, len(anchors_f) - 2)
    frac = np.clip((freqs_out - anchors_f[si])
                   / (anchors_f[si + 1] - anchors_f[si]), 0.0, 1.0)
    c["si"] = torch.as_tensor(si, device=device)
    c["frac"] = torch.as_tensor(frac.astype(np.float32), device=device)
    return c


def _windowed(x, origin, cf0, fs: int, ratio: float, kind: str,
              max_hw: int, n_valid: int):
    """F0-adaptive windowed segments in a fixed (F, 2*max_hw+1) slot
    (jax_analysis._jax_windowed), one per frame.

    The counterpart of common.get_windowed_waveform: indices are edge-
    clipped (not zeroed), the window is evaluated on index offsets, and the
    window-weighted mean is subtracted.  The segment sits time-shifted in
    the slot relative to the host's 0-origin layout, which is immaterial:
    every D4C quantity built from it is invariant to a common shift.
    Returns (segments, per-frame half lengths)."""
    base = torch.arange(-max_hw, max_hw + 1, device=x.device)
    half = torch.floor(rdiv(ratio * fs, cf0) / 2.0 + 0.5).long()
    mask = torch.abs(base)[None, :] <= half[:, None]
    seg = x[torch.clamp(origin[:, None] + base[None, :], 0, n_valid - 1)]
    posf0 = ((2.0 * base / ratio) / fs)[None, :] * cf0[:, None]
    if kind == "blackman":
        w = (0.42 + 0.5 * torch.cos(math.pi * posf0)
             + 0.08 * torch.cos(2.0 * math.pi * posf0))
    else:  # hanning
        w = 0.5 + 0.5 * torch.cos(math.pi * posf0)
    w = torch.where(mask, w, 0.0)
    seg = seg * w
    return seg - w * (torch.sum(seg, 1, keepdim=True)
                      / torch.sum(w, 1, keepdim=True)), half


def _origins(time_axis, fs: int):
    return torch.floor(time_axis * fs + 0.501).long()


def device_d4c(x, f0, time_axis, fs: int, fft_size: int = 1024,
               threshold: float = 0.85, f0_ceil: float = 1000.0,
               n_valid=None, device="cuda") -> torch.Tensor:
    """D4C band aperiodicity batched over frames, the port of
    jax_analysis.jax_d4c (the host estimator is d4c.py): fixed window
    slots with per-frame F0-adaptive masks, batched FFTs and a static
    anchor interpolation.

    x: (n,) waveform; f0/time_axis: (F,).
    Returns (F, fft_size//2+1) aperiodicity in (0, 1]."""
    x = as_signal(x, device)
    dev = x.device
    f0 = as_signal(f0, dev)
    time_axis = as_signal(time_axis, dev)
    c = _d4c_static(fs, fft_size, dev)
    n_valid = x.shape[0] if n_valid is None else n_valid
    ceil_f0 = max(float(f0_ceil), FLOOR_F0_D4C)
    F = f0.shape[0]
    origins = _origins(time_axis, fs)

    # --- love train: low/high band power ratio voicing pre-test ---
    seg, _ = _windowed(x, origins, torch.clamp_min(f0, 40.0), fs, 3.0,
                       "blackman", c["max_hw_lt"], n_valid)
    cum = torch.cumsum(torch.abs(torch.fft.rfft(seg, c["fft_lt"], dim=1))
                       ** 2, dim=1)
    b0, b1, b2 = c["b0"], c["b1"], c["b2"]
    love = (cum[:, b1] - cum[:, b0]) / torch.clamp_min(
        cum[:, b2] - cum[:, b0], 1e-30)

    # --- static group delay ---
    cf0 = torch.clamp_min(f0, FLOOR_F0_D4C)
    fftd = c["fft_d4c"]
    max_hw = c["max_hw"]

    def centroid(off_sign):
        """Ramp-weighted spectral cross-centroid at position
        off_sign*0.25/f0."""
        org = _origins(time_axis + rdiv(off_sign * 0.25, cf0), fs)
        seg, half = _windowed(x, org, cf0, fs, 4.0, "blackman", max_hw,
                              n_valid)
        power = torch.sqrt(torch.sum(seg * seg, 1, keepdim=True))
        seg = torch.where(power > 0.0, seg / power.clamp_min(1e-30), 0.0)
        ramp = (torch.arange(-max_hw, max_hw + 1, device=dev)[None, :]
                + half[:, None] + 1)
        s1 = torch.fft.rfft(seg, fftd, dim=1)
        s2 = torch.fft.rfft(seg * ramp, fftd, dim=1)
        return s1.real * s2.real + s1.imag * s2.imag

    jmax = min(2 + int(ceil_f0 * fftd / fs) + 2, fftd // 2)
    kmax = int(np.ceil(ceil_f0 / (fs / fftd) / 2)) + 2

    if c["n_bands"] == 0:
        # narrowband fs (<= ~8 kHz): no 3 kHz coarse bands below
        # fs/2 - 3000 — the spectrum interpolates straight between the DC
        # and Nyquist anchors, exactly as the host path does
        coarse = torch.zeros((F, 0), device=dev)
    else:
        static_centroid = _dc_correct(centroid(-1.0) + centroid(1.0), cf0,
                                      fs, fftd, jmax)
        seg, _ = _windowed(x, origins, cf0, fs, 4.0, "hanning", max_hw,
                           n_valid)
        sm_ps = torch.abs(torch.fft.rfft(seg, fftd, dim=1)) ** 2
        sm_ps = _dc_correct(sm_ps, cf0, fs, fftd, jmax)
        sm_ps = _linear_smoothing(sm_ps, cf0, fs, fftd, kmax)

        sgd = static_centroid / sm_ps.clamp_min(1e-30)
        sgd = _linear_smoothing(sgd, cf0 / 2.0, fs, fftd, kmax)
        sgd = sgd - _linear_smoothing(sgd, cf0, fs, fftd, kmax)

        # --- coarse aperiodicity per 3 kHz band ---
        halfd = c["half_d4c"]
        coarse = []
        for i in range(c["n_bands"]):
            seg = torch.where(c["band_ok"][i][None, :],
                              sgd[:, c["band_idx"][i]], 0.0)
            ps = torch.abs(torch.fft.rfft(seg * c["window"], fftd,
                                          dim=1)) ** 2
            cum = torch.cumsum(torch.sort(ps, dim=1).values, dim=1)
            coarse.append(10.0 * torch.log10(
                cum[:, halfd - c["boundary"] - 1].clamp_min(1e-30)
                / cum[:, halfd]))
        coarse = torch.stack(coarse, dim=1)             # (F, n_bands)
        coarse = torch.clamp_max(coarse + (cf0[:, None] - 100.0) / 50.0,
                                 0.0)

    # --- interpolate band anchors over the output spectrum ---
    anchors_db = torch.cat([torch.full((F, 1), -60.0, device=dev), coarse,
                            torch.full((F, 1), -1e-12, device=dev)], dim=1)
    ap_db = (anchors_db[:, c["si"]] * (1.0 - c["frac"])
             + anchors_db[:, c["si"] + 1] * c["frac"])
    ap = torch.pow(10.0, ap_db / 20.0)

    voiced = (f0 > 0.0) & (love > threshold)
    ap = torch.where(voiced[:, None], ap, UNVOICED_AP)
    return torch.clamp(ap, 1e-12, UNVOICED_AP)


@functools.lru_cache(maxsize=8)
def _freqt_matrix(m1p1: int, order: int, alpha: float,
                  device: torch.device) -> torch.Tensor:
    """(m1p1, order+1) float32 matrix of the freqt recursion.  The
    recursion is linear in the cepstrum, so its rows are mcep.freqt of the
    unit vectors, computed in float64 on the host."""
    return torch.as_tensor(freqt(np.eye(m1p1), order, alpha).astype(
        np.float32), device=device)


def device_freqt(c, order: int, alpha: float) -> torch.Tensor:
    """Frequency warping of cepstrum rows c (F, M1+1) -> (F, order+1), the
    port of jax_analysis.jax_freqt.

    jax_freqt runs the SPTK recursion as a scan over the M1+1 input
    coefficients (513 steps for a 1024-point spectrum, each an order-long
    recurrence).  The recursion is linear in c, so the same map is one
    product with the matrix the recursion makes of the identity."""
    return c @ _freqt_matrix(c.shape[-1], int(order), float(alpha),
                             c.device)


def device_sp2mc(powerspec, order: int, alpha: float) -> torch.Tensor:
    """Power spectrogram (F, fftl//2+1) -> mel-cepstra (F, order+1), the
    port of jax_analysis.jax_sp2mc."""
    logsp = torch.log(powerspec.clamp_min(1e-30))
    c = torch.fft.irfft(logsp, dim=-1)[:, : powerspec.shape[-1]]
    c = torch.cat([c[:, :1] * 0.5, c[:, 1:]], dim=1)
    return device_freqt(c, order, alpha)


@functools.lru_cache(maxsize=8)
def _codeap_index(fs: int, fft_size: int, device: torch.device):
    """codec.code_aperiodicity's band-center bins, on the device."""
    half = fft_size // 2 + 1
    idx = np.minimum((band_frequencies(fs) / (fs / 2.0)
                      * (half - 1)).round().astype(int), half - 1)
    return torch.as_tensor(idx, device=device)


def device_analyze(x, fs: int, n_valid: int, f_valid: int, alpha: float,
                   fft_size: int = 1024, mcep_dim: int = 34,
                   f0_floor: float = 71.0, f0_ceil: float = 800.0,
                   frame_period: float = 5.0,
                   cheaptrick_floor: float = 71.0,
                   f0_analyzer: str = "harvest", device="cuda"):
    """The whole analysis — F0, spectral envelope, aperiodicity,
    mel-cepstrum, coded aperiodicity, normalized power — in one pass on
    the device, the port of jax_analysis.jax_analyze.

    x: (n,) waveform padded to a whole-second bucket; n_valid: true sample
    count; f_valid: true frame count — only the first f_valid frames enter
    the npow utterance mean.  alpha: mcep all-pass constant.
    Returns (f0, mcep, codeap, npow) at the PADDED frame count; callers
    slice to f_valid."""
    x = as_signal(x, device)
    mark("upload", x.device)
    kw = dict(n_valid=n_valid, f0_floor=f0_floor, f0_ceil=f0_ceil,
              frame_period=frame_period)
    if f0_analyzer == "harvest":
        f0 = device_harvest(x, fs, **kw)
    else:
        f0 = device_stonemask(x, device_dio(x, fs, **kw), fs, **kw)
        mark("F0", x.device)
    F = f0.shape[0]
    # the f64 axis cast to f32, as the staged path's host-side t32
    time_axis = frame_axis(F, frame_period, x.device)

    spc = device_cheaptrick(x, f0, time_axis, fs, fft_size=fft_size,
                            f0_floor=cheaptrick_floor, f0_ceil=f0_ceil,
                            n_valid=n_valid)
    mark("CheapTrick", x.device)
    ap = device_d4c(x, f0, time_axis, fs, fft_size=fft_size,
                    f0_ceil=max(f0_ceil, 1000.0), n_valid=n_valid)
    mark("D4C", x.device)
    mcep = device_sp2mc(spc, mcep_dim, alpha)
    mark("mcep", x.device)

    # coded aperiodicity: band-center samples in dB (codec.code_aperiodicity)
    codeap = 20.0 * torch.log10(
        ap[:, _codeap_index(fs, fft_size, x.device)].clamp_min(1e-12))

    # normalized frame power in dB (mcep.spectrogram2npow), with the
    # utterance mean taken over the true frames only
    pows = (spc[:, 0] + spc[:, -1]
            + 2.0 * torch.sum(spc[:, 1:-1], dim=1)) / fft_size
    mask = torch.arange(F, device=x.device) < f_valid
    meanpow = torch.sum(torch.where(mask, pows, 0.0)) / f_valid
    npow = 10.0 * torch.log10(pows.clamp_min(1e-30)
                              / meanpow.clamp_min(1e-30))
    mark("codeap, npow", x.device)
    return f0, mcep, codeap, npow
