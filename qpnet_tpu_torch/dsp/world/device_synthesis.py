"""Device WORLD synthesis in plain PyTorch, the port of
`qpnet_tpu/dsp/world/jax_synthesis.py`.

The host path (synthesis.py) walks the excitation pulses in a Python loop.
Here the same construction is fixed-shape tensor work on the device the
inputs lie on (CUDA unless the caller asks for the CPU):

  * pulse positions come from the integer-cycle crossings of the cumulative
    instantaneous frequency (the host's wrapped-phase jumps, since a sample
    never advances the phase by half a cycle), found for a static number
    of slots `P_max = n*ceil(F0)/fs + 2` by a `searchsorted` of the cycle
    counts, so nothing waits for the device;
  * every pulse's periodic response (the minimum-phase spectrum of
    sqrt(sp*(1-ap^2)), the fractional-position phase ramp, the DC remover)
    and aperiodic burst (zero-mean masked noise filtered by the
    minimum-phase response of sqrt(sp*ap^2)) are built for all slots at
    once with batched FFTs; invalid slots are masked to zero;
  * the responses overlap-add as in the JAX package: each is placed in the
    2*fftl frame of its fftl-sample chunk by a spectral phase ramp, the
    frames are summed over pulses by one product with a one-hot matrix,
    and the frames overlap-add at stride fftl.  No scatter, so the sums
    run in one fixed order and a seed gives the same bits every call.

The waveform is float32.  The pulse track alone (the F0 interpolation and
the cumulative phase over the n samples) runs in float64: in float32 the
cumulative phase moves an isolated crossing by a sample (the JAX package's
gate allows it), in float64 the pulse times (index plus fractional shift)
are the host's within rounding.  Where the phase lands on a whole cycle
(the 500 Hz unvoiced default does every 441 samples at 22,050 Hz),
rounding picks between an index with a shift of one sample and the next
index with a shift of 0: the same time.  The aperiodic
bursts are drawn from a `torch.Generator` seeded with `seed`:
deterministic per (seed, shape), equal to the JAX package's PRNG stream
only in distribution.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from qpnet_tpu_torch.dsp.world.codec import band_frequencies
from qpnet_tpu_torch.dsp.world.synthesis import DEFAULT_F0, _dc_remover


def _on(t, device) -> torch.Tensor:
    from qpnet_tpu_torch.models.qpnet import resolve_device
    if isinstance(t, torch.Tensor):
        return t
    return torch.as_tensor(np.asarray(t), device=resolve_device(device))


@functools.lru_cache(maxsize=8)
def _fold(fftl: int, device: torch.device) -> torch.Tensor:
    """The cepstral fold of common.minimum_phase_spectrum: double the
    positive quefrencies, keep c[0] and c[fftl/2], zero the negative half."""
    return torch.cat([torch.ones(1), 2.0 * torch.ones(fftl // 2 - 1),
                      torch.ones(1), torch.zeros(fftl // 2 - 1)]).to(device)


@functools.lru_cache(maxsize=8)
def _dc_rem(fftl: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_dc_remover(fftl), dtype=torch.float32,
                           device=device)


def _min_phase(log_amp: torch.Tensor, fftl: int) -> torch.Tensor:
    """Batched minimum-phase spectrum (cepstral method): (P, half+1) real
    log-amplitude -> (P, half+1) complex."""
    c = torch.fft.irfft(log_amp, n=fftl, dim=-1)
    return torch.exp(torch.fft.rfft(c * _fold(fftl, c.device), dim=-1))


def _pulse_slots(f0: torch.Tensor, fs: int, frame_period: float,
                 n_samples: int, p_max: int):
    """Excitation pulse slots with a static bound, from f0 (F,) float64.

    Returns (pulses int64, shift_s float64, voiced, valid), each of length
    p_max + 1 (one extra slot for the host path's prepended t=0 pulse when
    the first phase wrap falls inside the signal)."""
    dev = f0.device
    F = f0.shape[0]
    fp_s = frame_period / 1000.0
    # per-sample linear interpolation of the frame-rate track (host:
    # np.interp over the uniform frame grid, clamped at both ends)
    pos = torch.arange(n_samples, dtype=torch.float64, device=dev) / (fp_s * fs)
    i0 = torch.clamp(torch.floor(pos).long(), 0, max(F - 2, 0))
    i1 = torch.clamp(i0 + 1, max=F - 1)
    w = torch.clamp(pos - i0, 0.0, 1.0)
    f0v = torch.where(f0 > 0, f0, 0.0)
    f0_interp = (1.0 - w) * f0v[i0] + w * f0v[i1]
    vflag = (f0 > 0).to(torch.float64)
    voiced_interp = ((1.0 - w) * vflag[i0] + w * vflag[i1]) > 0.5
    inst = torch.where(voiced_interp & (f0_interp > 0), f0_interp, DEFAULT_F0)

    # integer-cycle crossings of the cumulative frequency: the k-th falls
    # between samples i and i+1 where the cycle count first reaches
    # count[0] + k; missing slots point at the last sample, as JAX's
    # nonzero(size=, fill_value=n-1) fills them
    cycles = torch.cumsum(inst / fs, 0)
    ci = torch.floor(cycles)
    k = torch.arange(1, p_max + 1, dtype=torch.float64, device=dev)
    found = torch.searchsorted(ci[1:].contiguous(), ci[0] + k)
    n_found = ci[-1] - ci[0]
    valid_f = torch.arange(p_max, device=dev) < n_found
    # sub-sample crossing position (host: -y1/(y2-y1) on the wrapped
    # phase), in cycles: (1-r1)/(r2+1-r1) with r = frac(cycles)
    r = cycles - ci
    r1 = r[found]
    r2 = r[torch.clamp(found + 1, max=n_samples - 1)]
    shift_f = (1.0 - r1) / torch.clamp(r2 + 1.0 - r1, min=1e-12) / fs

    # the host prepends a t=0 pulse when the first wrap is not at sample 0
    prepend = (n_found == 0) | (found[0] != 0)
    z = torch.zeros(1, dtype=torch.int64, device=dev)
    last = torch.full((1,), n_samples - 1, dtype=torch.int64, device=dev)
    pulses = torch.where(prepend, torch.cat([z, found]),
                         torch.cat([found, last]))
    zf = torch.zeros(1, dtype=torch.float64, device=dev)
    shift = torch.where(prepend, torch.cat([zf, shift_f]),
                        torch.cat([shift_f, zf]))
    one_b = torch.ones(1, dtype=torch.bool, device=dev)
    valid = torch.where(prepend, torch.cat([one_b, valid_f]),
                        torch.cat([valid_f, ~one_b]))
    voiced = voiced_interp[pulses]
    return pulses, shift, voiced, valid


def _ceil_and_slots(n_samples: int, fs: int, f0_ceil: float):
    ceil_eff = max(float(f0_ceil), DEFAULT_F0)
    return ceil_eff, int(n_samples * ceil_eff / fs) + 2


def device_synthesize(f0, sp, ap, seed: int, fs: int,
                      frame_period: float = 5.0, f0_ceil: float = 800.0,
                      device="cuda") -> torch.Tensor:
    """f0 (F,), spectral envelope sp (F, fftl//2+1), aperiodicity ap
    (F, fftl//2+1) -> waveform (F * frame_period * fs / 1000,) float32 on
    the inputs' device, the port of jax_synthesis.jax_synthesize.

    Arrays go to `device`, tensors stay where they are.  f0 is taken in
    float64 for the pulse track (give float64 for the host's pulse times).
    `f0_ceil` bounds the pulse count; the instantaneous frequency is
    clipped to max(f0_ceil, 500) (a track above the ceiling would overflow
    the static pulse slots).  `seed` drives the aperiodic bursts: every
    call with the same seed and shapes draws the same noise."""
    f0 = _on(f0, device).to(torch.float64)
    dev = f0.device
    sp = _on(sp, dev).to(torch.float32)
    ap = _on(ap, dev).to(torch.float32)
    F, half1 = sp.shape
    fftl = (half1 - 1) * 2
    fp_s = frame_period / 1000.0
    n_samples = int(F * fp_s * fs)
    ceil_eff, p_max = _ceil_and_slots(n_samples, fs, f0_ceil)

    pulses, shift, voiced, valid = _pulse_slots(
        torch.clamp(f0, max=ceil_eff), fs, frame_period, n_samples, p_max)
    P = p_max + 1

    # interval to the next pulse (host: the last pulse reuses the previous
    # gap, a lone pulse defaults to fftl)
    nxt = torch.cat([pulses[1:], pulses[-1:]])
    prv = torch.cat([pulses[:1], pulses[:-1]])
    k = torch.arange(P, device=dev)
    n_valid_p = valid.sum()
    interval = torch.where(
        k == n_valid_p - 1,
        torch.where(k > 0, pulses - prv, fftl),
        nxt - pulses)
    interval = torch.clamp(interval, min=1)
    # the noise burst lives in an fftl slot (host rfft(noise, fftl) crops
    # longer bursts identically); the energy normalization keeps the true
    # interval
    interval_n = torch.clamp(interval, max=fftl)

    # frame-interpolated envelope and aperiodicity at each pulse time
    # (host _frame_interp: clamped linear interpolation between rows)
    posf = (pulses.to(torch.float64) / fs) / fp_s
    j0 = torch.clamp(torch.floor(posf).long(), 0, max(F - 2, 0))
    j1 = torch.clamp(j0 + 1, max=F - 1)
    wf = torch.clamp(posf - j0, 0.0, 1.0).to(torch.float32)[:, None]
    sp_p = torch.clamp((1.0 - wf) * sp[j0] + wf * sp[j1], min=1e-30)
    ap_p = torch.clamp((1.0 - wf) * ap[j0] + wf * ap[j1], 1e-12, 1.0 - 1e-12)
    ap_ratio = ap_p * ap_p

    # periodic response: minimum-phase IR of sp*(1-ap^2), delayed by the
    # fractional pulse position as a spectral phase ramp, DC-removed,
    # scaled by sqrt(interval) (line-spectrum energy normalization)
    periodic_on = voiced & (ap_ratio[:, 0] <= 0.999) & valid
    per_pow = sp_p * (1.0 - ap_ratio)
    mp = _min_phase(0.5 * torch.log(torch.clamp(per_pow, min=1e-30)), fftl)
    bins = torch.arange(half1, dtype=torch.float32, device=dev)
    coeff = (2.0 * math.pi * shift * fs / fftl).to(torch.float32)
    ph = coeff[:, None] * bins[None, :]
    ramp = torch.polar(torch.ones_like(ph), -ph)
    ir = torch.fft.irfft(mp * ramp, n=fftl, dim=-1)
    ir = ir + ir.sum(dim=-1, keepdim=True) * _dc_rem(fftl, dev)[None, :]
    periodic = torch.where(
        periodic_on[:, None],
        ir * torch.sqrt(interval.to(torch.float32))[:, None], 0.0)

    # aperiodic burst: zero-mean noise over the pulse interval, filtered by
    # the minimum-phase response of sp*ap^2 (the full envelope when the
    # periodic path is gated off)
    noise_pow = torch.where(periodic_on[:, None], sp_p * ap_ratio, sp_p)
    mpn = _min_phase(0.5 * torch.log(torch.clamp(noise_pow, min=1e-30)),
                     fftl)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    noise = torch.randn((P, fftl), generator=gen, device=dev)
    nmask = (torch.arange(fftl, device=dev)[None, :]
             < interval_n[:, None]).to(torch.float32)
    nz = noise * nmask
    nz = nz - nmask * (nz.sum(dim=-1, keepdim=True)
                       / interval_n[:, None].to(torch.float32))
    burst = torch.fft.irfft(torch.fft.rfft(nz, dim=-1) * mpn, n=fftl, dim=-1)

    resp = (periodic + burst) * valid[:, None].to(torch.float32)

    # overlap-add: a pulse at p = c*fftl + off lands inside the 2*fftl
    # frame anchored at chunk c; a spectral phase ramp places it there
    # (off < fftl, so no wrap), one one-hot product sums the frames over
    # pulses, and the frames overlap-add at stride fftl
    n_frames = (n_samples - 1) // fftl + 1
    c_id = pulses // fftl
    off = (pulses - c_id * fftl).to(torch.float32)
    S2 = torch.fft.rfft(resp, n=2 * fftl, dim=-1)
    k2 = torch.arange(fftl + 1, dtype=torch.float32, device=dev)
    ph2 = (math.pi / fftl) * off[:, None] * k2[None, :]
    S2 = S2 * torch.polar(torch.ones_like(ph2), -ph2)
    onehot = (c_id[:, None] == torch.arange(n_frames, device=dev)[None, :]
              ).to(S2.dtype)
    frames = torch.fft.irfft(onehot.transpose(0, 1) @ S2, n=2 * fftl, dim=-1)
    out = torch.zeros((n_frames + 1, fftl), dtype=torch.float32, device=dev)
    out[:n_frames] += frames[:, :fftl]
    out[1:] += frames[:, fftl:]
    return out.reshape(-1)[:n_samples]


@functools.lru_cache(maxsize=8)
def _ap_decode_index(fs: int, half1: int, device: torch.device):
    """codec.decode_aperiodicity's anchor interpolation: (si, fr) per bin,
    on the device."""
    bands = band_frequencies(fs)
    anchors_f = np.concatenate([[0.0], bands, [fs / 2.0]])
    freqs = np.linspace(0.0, fs / 2.0, half1)
    si = np.clip(np.searchsorted(anchors_f, freqs, side="right") - 1,
                 0, len(anchors_f) - 2)
    fr = ((freqs - anchors_f[si])
          / (anchors_f[si + 1] - anchors_f[si])).astype(np.float32)
    return (torch.as_tensor(si, device=device),
            torch.as_tensor(fr, device=device))


def device_restore(f0, mcep, codeap, alpha: float, seed: int, fs: int,
                   fftl: int = 1024, frame_period: float = 5.0,
                   f0_ceil: float = 800.0, device="cuda") -> torch.Tensor:
    """The restore transform, mel-cepstrum + coded aperiodicity ->
    waveform, as one device pass (the port of jax_synthesis.jax_restore):
    the upload is the coded features, not full spectra.

    mc2sp is evaluated directly on the warped frequency axis,
    log S(w_k) = 2 * sum_m mc[m] cos(m * beta(w_k)) with beta the
    first-order all-pass phase; the coarse aperiodicity decodes linear in
    dB between the anchors [0 Hz: -60 dB, the 3 kHz bands: coded, fs/2:
    ~0 dB]."""
    f0 = _on(f0, device)
    dev = f0.device
    mcep = _on(mcep, dev).to(torch.float32)
    codeap = _on(codeap, dev).to(torch.float32)
    half1 = fftl // 2 + 1
    w = torch.linspace(0.0, math.pi, half1, dtype=torch.float64,
                       device=dev).to(torch.float32)
    a = torch.tensor(float(alpha), dtype=torch.float32)
    beta = w + 2.0 * torch.atan2(a * torch.sin(w), 1.0 - a * torch.cos(w))
    m = torch.arange(mcep.shape[1], dtype=torch.float32, device=dev)
    sp = torch.exp(2.0 * (mcep @ torch.cos(m[:, None] * beta[None, :])))

    si, fr = _ap_decode_index(fs, half1, dev)
    F = codeap.shape[0]
    anch_db = torch.cat([
        torch.full((F, 1), -60.0, dtype=torch.float32, device=dev), codeap,
        torch.full((F, 1), -1e-12, dtype=torch.float32, device=dev)], dim=1)
    ap_db = anch_db[:, si] * (1.0 - fr) + anch_db[:, si + 1] * fr
    ap = torch.clamp(10.0 ** (ap_db / 20.0), 1e-12, 1.0 - 1e-12)
    return device_synthesize(f0, sp, ap, seed, fs, frame_period=frame_period,
                             f0_ceil=f0_ceil)


def pulse_times_debug(f0: np.ndarray, fs: int, frame_period: float,
                      f0_ceil: float = 800.0, device="cuda"):
    """The device pulse track on the host, for checks against
    synthesis._pulse_times: (idx, shift_seconds, voiced) with the invalid
    slots stripped."""
    f0 = _on(np.asarray(f0, np.float64), device)
    F = f0.shape[0]
    n_samples = int(F * frame_period / 1000.0 * fs)
    ceil_eff, p_max = _ceil_and_slots(n_samples, fs, f0_ceil)
    pulses, shift, voiced, valid = _pulse_slots(
        torch.clamp(f0, max=ceil_eff), fs, frame_period, n_samples, p_max)
    m = valid.cpu().numpy()
    return (pulses.cpu().numpy()[m], shift.cpu().numpy()[m],
            voiced.cpu().numpy()[m])
