"""High-level WORLD analysis and synthesis API, the port of
`qpnet_tpu/dsp/world/api.py`.

WorldAnalyzer.analyze(x) -> (f0, spc, ap)    [F0, cheaptrick, d4c]
           .mcep(dim, alpha)                 [sp2mc of the envelope]
           .codeap()                         [band aperiodicity, dB]
           .npow()                           [normalized frame power, dB]
           .extract_all(x, dim, alpha)       [all of it on the device]
WorldSynthesizer.synthesis(f0, mcep, ap, alpha)   [mc2sp -> synthesize]
                .restore_async(f0, mcep, codeap)  [all of it on the device]
                .synthesis_diff(x, diffmcep, alpha) [MLSA filtering]

The backend values are the JAX package's, so callers of the two packages
are interchangeable: "numpy" is the float64 host path, bit-equal to the
JAX package's; "jax" means "on the torch device" here — float32 PyTorch on
`device` (CUDA unless the caller asks for the CPU), the port of the JAX
device modules (device_f0.py, device_analysis.py, device_synthesis.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from qpnet_tpu_torch.dsp.mcep import mc2sp, sp2mc, spectrogram2npow
from qpnet_tpu_torch.dsp.mlsa import synthesis_diff as _mlsa_synthesis_diff
from qpnet_tpu_torch.dsp.world.cheaptrick import cheaptrick
from qpnet_tpu_torch.dsp.world.codec import code_aperiodicity
from qpnet_tpu_torch.dsp.world.d4c import d4c
from qpnet_tpu_torch.dsp.world.dio import dio
from qpnet_tpu_torch.dsp.world.harvest import harvest
from qpnet_tpu_torch.dsp.world.stonemask import stonemask
from qpnet_tpu_torch.dsp.world.synthesis import synthesize


def _bucket_pad_signal(x: np.ndarray, fs: int) -> Tuple[np.ndarray, int]:
    """Zero-pad to a whole-second bucket as float32: (x32, n_valid).

    The device F0 and the device spectral stages pad with this one helper,
    so the staged and fused paths see the same signal."""
    n = len(x)
    secs = max(1, -(-n // fs))
    x32 = np.zeros(secs * fs, np.float32)
    x32[:n] = x
    return x32, n


def _upload(x: np.ndarray, device, dtype=np.float32) -> torch.Tensor:
    """x as `dtype` on `device`, copied without waiting for the device
    (pinned host memory) when that is a CUDA device."""
    from qpnet_tpu_torch.models.qpnet import resolve_device
    dev = resolve_device(device)
    t = torch.from_numpy(np.ascontiguousarray(x, dtype))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


class WorldAnalyzer:
    def __init__(self, fs: int = 22050, shiftms: float = 5.0,
                 minf0: float = 40.0, maxf0: float = 800.0,
                 fftl: int = 1024, f0_analyzer: str = "harvest",
                 backend: str = "numpy", f0_backend: str = "host",
                 device="cuda"):
        self.f0_analyzer = f0_analyzer  # "harvest" (sprocket default) | "dio"
        # backend: "numpy" = float64 host path (reference-parity default);
        # "jax" = CheapTrick/D4C/mcep on the torch device (float32)
        # f0_backend: "host" = numpy harvest/dio (reference-parity
        # default); "jax" = harvest or dio+stonemask on the device
        # (device_f0.py) — with backend="jax" the whole analysis runs there
        self.backend = backend
        self.f0_backend = f0_backend
        self.device = device            # resolved when a device stage runs
        self.fs = fs
        self.shiftms = shiftms
        self.minf0 = minf0
        self.maxf0 = maxf0
        self.fftl = fftl
        self._f0 = None
        self._spc = None
        self._ap = None
        self._time_axis = None

    def _upload(self, x: np.ndarray, dtype=np.float32) -> torch.Tensor:
        return _upload(x, self.device, dtype)

    def _frames(self, n: int) -> int:
        return int(n / (self.fs * self.shiftms / 1000.0)) + 1

    def estimate_f0(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """F0 track (harvest or dio+stonemask): (f0, time_axis).

        f0_backend="host": pure numpy.  f0_backend="jax": the device
        estimator (device_f0.device_harvest, or device_dio +
        device_stonemask) on the whole-second bucket that analyze() pads
        to."""
        x = np.asarray(x, np.float64)
        if self.f0_backend == "jax":
            from qpnet_tpu_torch.dsp.world.device_f0 import (
                device_dio, device_harvest, device_stonemask,
            )
            n = len(x)
            F = self._frames(n)
            x32, _ = _bucket_pad_signal(x, self.fs)
            xd = self._upload(x32)
            kw = dict(n_valid=n, f0_floor=float(self.minf0),
                      f0_ceil=float(self.maxf0),
                      frame_period=float(self.shiftms))
            if self.f0_analyzer == "harvest":
                f0 = device_harvest(xd, self.fs, **kw)
            else:
                f0 = device_stonemask(xd, device_dio(xd, self.fs, **kw),
                                      self.fs, **kw)
            time_axis = np.arange(F) * (self.shiftms / 1000.0)
            return f0.cpu().numpy().astype(np.float64)[:F], time_axis
        if self.f0_analyzer == "harvest":
            return harvest(x, self.fs, f0_floor=self.minf0,
                           f0_ceil=self.maxf0, frame_period=self.shiftms)
        f0, time_axis = dio(x, self.fs, f0_floor=self.minf0,
                            f0_ceil=self.maxf0, frame_period=self.shiftms)
        return stonemask(x, f0, time_axis, self.fs), time_axis

    def extract_all(self, x: np.ndarray, dim: int = 34,
                    alpha: float = 0.455):
        """The fused device extraction: (f0, mcep, codeap, npow) — the
        whole per-utterance feature surface — queued as one pass and
        fetched with one copy.

        Requires backend="jax" AND f0_backend="jax" (either analyzer);
        callers that need the raw spc/ap arrays use analyze() instead.
        Returns dict(f0, time_axis, mcep, codeap, npow), host float64."""
        return self.extract_all_fetch(self.extract_all_async(x, dim, alpha))

    def extract_all_async(self, x: np.ndarray, dim: int = 34,
                          alpha: float = 0.455):
        """Queue the fused extraction on the device's stream without waiting
        for it: returns an opaque handle for extract_all_fetch, so a caller
        can queue the next utterance while the device still runs this one."""
        if not (self.backend == "jax" and self.f0_backend == "jax"):
            raise RuntimeError("extract_all needs backend='jax' and "
                               "f0_backend='jax'")
        from qpnet_tpu_torch.dsp.world.device_analysis import device_analyze

        x = np.asarray(x, np.float64)
        n = len(x)
        F = self._frames(n)
        x32, _ = _bucket_pad_signal(x, self.fs)
        cheaptrick_floor = max(self.minf0, 71.0 * 1024 / self.fftl)
        out = device_analyze(
            self._upload(x32), self.fs, n, F, float(alpha),
            fft_size=self.fftl, mcep_dim=dim, f0_floor=float(self.minf0),
            f0_ceil=float(self.maxf0), frame_period=float(self.shiftms),
            cheaptrick_floor=cheaptrick_floor, f0_analyzer=self.f0_analyzer)
        return out, F

    def extract_all_fetch(self, handle):
        """Wait for an extract_all_async handle: one copy to the host,
        host float64 dict."""
        (f0, mcep, codeap, npow), F = handle
        packed = torch.cat([f0[:, None], mcep, codeap, npow[:, None]],
                           dim=1).cpu().numpy().astype(np.float64)[:F]
        d = mcep.shape[1]
        return {
            "f0": packed[:, 0],
            "time_axis": np.arange(F) * (self.shiftms / 1000.0),
            "mcep": packed[:, 1: 1 + d],
            "codeap": packed[:, 1 + d: -1],
            "npow": packed[:, -1],
        }

    def analyze(self, x: np.ndarray, f0_time=None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """f0_time: optional precomputed (f0, time_axis) from estimate_f0 —
        lets a caller pipeline host F0 against device spectral analysis."""
        x = np.asarray(x, np.float64)
        if f0_time is not None:
            f0, time_axis = f0_time
        else:
            f0, time_axis = self.estimate_f0(x)
        cheaptrick_floor = max(self.minf0, 71.0 * 1024 / self.fftl)
        if self.backend == "jax":
            from qpnet_tpu_torch.dsp.world.device_analysis import (
                device_cheaptrick, device_d4c,
            )
            F = len(f0)
            # the whole-second buckets of the fused path; n_valid masks the
            # zero pad exactly
            x32, n = _bucket_pad_signal(x, self.fs)
            secs = len(x32) // self.fs
            frames_per_sec = int(round(1000.0 / self.shiftms))
            F_pad = max(F, secs * frames_per_sec + 1)
            f32 = np.zeros(F_pad, np.float32)
            f32[:F] = f0
            t32 = np.arange(F_pad, dtype=np.float32) * (self.shiftms / 1000)
            t32[:F] = time_axis
            xd = self._upload(x32)
            f0d, td = self._upload(f32), self._upload(t32)
            spc = device_cheaptrick(
                xd, f0d, td, self.fs, fft_size=self.fftl,
                f0_floor=cheaptrick_floor, f0_ceil=float(self.maxf0),
                n_valid=n)
            ap = device_d4c(xd, f0d, td, self.fs, fft_size=self.fftl,
                            f0_ceil=float(max(self.maxf0, 1000.0)),
                            n_valid=n)
            spc = spc.cpu().numpy().astype(np.float64)[:F]
            ap = ap.cpu().numpy().astype(np.float64)[:F]
        else:
            spc = cheaptrick(x, f0, time_axis, self.fs, fft_size=self.fftl,
                             f0_floor=cheaptrick_floor)
            ap = d4c(x, f0, time_axis, self.fs, fft_size=self.fftl)
        self._f0, self._spc, self._ap = f0, spc, ap
        self._time_axis = time_axis
        return f0, spc, ap

    def _require(self):
        if self._spc is None:
            raise RuntimeError("call analyze() first")

    def mcep(self, dim: int = 34, alpha: float = 0.455) -> np.ndarray:
        self._require()
        if self.backend == "jax":
            from qpnet_tpu_torch.dsp.world.device_analysis import device_sp2mc
            # pad to the same whole-second frame buckets as analyze()
            F = self._spc.shape[0]
            frames_per_sec = int(round(1000.0 / self.shiftms))
            F_pad = -(-F // frames_per_sec) * frames_per_sec + 1
            spc = np.ones((F_pad, self._spc.shape[1]), np.float32)
            spc[:F] = self._spc
            mc = device_sp2mc(self._upload(spc), dim, alpha)
            return mc.cpu().numpy().astype(np.float64)[:F]
        return sp2mc(self._spc, dim, alpha)

    def codeap(self) -> np.ndarray:
        self._require()
        return code_aperiodicity(self._ap, self.fs)

    def npow(self) -> np.ndarray:
        self._require()
        return spectrogram2npow(self._spc)


class WorldSynthesizer:
    """backend: "numpy" = the float64 host pulse loop (reference-parity
    default); "jax" = the batched device synthesis (device_synthesis.py)
    on `device`, float32, the same construction with the noise drawn from
    a seeded `torch.Generator`."""

    def __init__(self, fs: int = 22050, fftl: int = 1024,
                 shiftms: float = 5.0, backend: str = "numpy",
                 device="cuda"):
        self.fs = fs
        self.fftl = fftl
        self.shiftms = shiftms
        self.backend = backend
        self.device = device            # resolved when a device pass runs

    def synthesis(self, f0: np.ndarray, mcep: np.ndarray, ap: np.ndarray,
                  alpha: float = 0.455) -> np.ndarray:
        """mcep-domain envelope + full-band aperiodicity -> waveform
        (sprocket Synthesizer.synthesis: mc2sp then WORLD synthesis).
        Units follow the analyzed signal's units (the reference analyzes
        int16-scale floats and writes the synthesis output as int16
        directly, feature_extract.py:267-272)."""
        if self.backend == "jax":
            return self.synthesis_fetch(
                self.synthesis_async(f0, mcep, ap, alpha=alpha))
        sp = mc2sp(mcep, alpha, self.fftl)
        return synthesize(f0, sp, ap, self.fs, frame_period=self.shiftms)

    def _bucket(self, f0: np.ndarray, *rows: np.ndarray):
        """Pad the frame axis to a whole-second bucket by repeating the
        last row (the interpolation clamps keep the pulse track over the
        true frames unchanged), so the output is deterministic per (seed,
        bucket); and the pulse-slot ceiling: 800 Hz covers speech, doubled
        until it covers the track.  Returns (f0 float64, rows float32,
        n_true, ceil) on the device."""
        F = len(f0)
        n_true = int(F * self.shiftms / 1000.0 * self.fs)
        frames_per_sec = int(round(1000.0 / self.shiftms))
        pad = max(1, -(-F // frames_per_sec)) * frames_per_sec - F
        ceil = 800.0
        fmax = float(f0.max(initial=0.0))
        while fmax > ceil:
            ceil *= 2.0
        f0d = _upload(np.concatenate([f0, np.repeat(f0[-1:], pad)]),
                      self.device, np.float64)
        rows = [_upload(np.concatenate([r, np.repeat(r[-1:], pad, 0)]),
                        self.device) for r in rows]
        return f0d, rows, n_true, ceil

    def synthesis_async(self, f0: np.ndarray, mcep: np.ndarray,
                        ap: np.ndarray, alpha: float = 0.455,
                        seed: int = 0):
        """Queue one utterance's device synthesis without waiting for it:
        returns a handle for synthesis_fetch, so a worker can queue
        utterance k+1 while the device still renders k.  mc2sp runs on the
        host in float64."""
        from qpnet_tpu_torch.dsp.world.device_synthesis import (
            device_synthesize)
        f0 = np.asarray(f0, np.float64)
        sp = mc2sp(mcep, alpha, self.fftl)
        ap = np.atleast_2d(np.asarray(ap, np.float64))
        f0d, (spd, apd), n_true, ceil = self._bucket(f0, sp, ap)
        out = device_synthesize(f0d, spd, apd, seed, self.fs,
                                frame_period=float(self.shiftms),
                                f0_ceil=ceil)
        return out, n_true

    def synthesis_fetch(self, handle) -> np.ndarray:
        """Wait for a synthesis_async or restore_async handle: float64
        waveform."""
        out, n_true = handle
        return out[:n_true].cpu().numpy().astype(np.float64)

    def restore_async(self, f0: np.ndarray, mcep: np.ndarray,
                      codeap: np.ndarray, alpha: float = 0.455,
                      seed: int = 0):
        """The fused device restore: mel-cepstrum + coded aperiodicity ->
        waveform in one pass (device_synthesis.device_restore), so the
        upload is the coded features, not full spectra.  Same bucketing
        and fetch as synthesis_async."""
        from qpnet_tpu_torch.dsp.world.device_synthesis import device_restore
        f0 = np.asarray(f0, np.float64)
        mcep = np.atleast_2d(np.asarray(mcep, np.float64))
        codeap = np.atleast_2d(np.asarray(codeap, np.float64))
        f0d, (mcd, cad), n_true, ceil = self._bucket(f0, mcep, codeap)
        out = device_restore(f0d, mcd, cad, float(alpha), seed, self.fs,
                             fftl=self.fftl,
                             frame_period=float(self.shiftms), f0_ceil=ceil)
        return out, n_true

    def synthesis_diff(self, x: np.ndarray, diffmcep: np.ndarray,
                       alpha: float = 0.455) -> np.ndarray:
        return _mlsa_synthesis_diff(x, diffmcep, alpha, self.shiftms, self.fs)
