"""High-level synthesis API: a trained QPNet experiment as one object, ported
from `qpnet_tpu/api.py`.

    from qpnet_tpu_torch import Vocoder
    voc = Vocoder.load("exp/qpnet_models/Avcc18tr_Wvcc18tr_d8",
                       stats="corpus/VCC2018/stats/vcc18tr_stats.h5")
    wav = voc.synthesize(feats)          # (F, n_aux) WORLD aux -> float32 wav

The conditioning is the decode CLI's (the same scaler, pitch-dependent
dilation factors from the optionally F0-scaled track, mu-law-zero seed and
`F*up - 1` samples), so `synthesize()` returns what `qpnet_decode` writes.
`stream()` yields audio chunks while the card generates them, through the
`StreamingGenerator` that the serving stack (qpnet_tpu_torch/serve.py) uses.
`vocode(wav)` analyzes a waveform with WORLD (`analyze`) and synthesizes it
again.  Everything runs on `device` (CUDA by default; "cpu" runs the
kernel's plain twin and the device analysis on the CPU).  `engine` and
`quantize` take what `batch_fast_generate` takes: the scan engine ("xla",
"int8_weights") serves `synthesize`; `stream` runs the kernel, which
streams "int8_weights" with bf16 weights, as the JAX package does.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np

from qpnet_tpu_torch.config import ModelConfig, RunConfig
from qpnet_tpu_torch.data.stats import Scaler, load_scaler
from qpnet_tpu_torch.models.qpnet import params_to, resolve_device
from qpnet_tpu_torch.ops import decode_mu_law, dilated_factor, encode_mu_law


class Vocoder:
    """A loaded QPNet model and its conditioning frontend.

    Construct with `Vocoder.load(...)` (an experiment directory) or directly
    from in-memory `params`/`cfg` (e.g. right after training).
    """

    def __init__(self, params, cfg: ModelConfig, scaler: Optional[Scaler],
                 fs: int = 22050, f0_dim_index: int = 1, seed: int = 100,
                 mode: str = "sampling", engine: str = "auto",
                 quantize: str = "none", device="cuda"):
        from qpnet_tpu_torch.models.generate import check_engine
        check_engine(engine, quantize)
        self.device = resolve_device(device)
        self.params, self.cfg = params_to(params, self.device), cfg
        # no stats: identity scaling, so callers pass features that are
        # already standardized (the training-domain contract)
        self.scaler = scaler if scaler is not None else Scaler.from_stats(
            np.zeros(cfg.n_aux), np.ones(cfg.n_aux))
        self.fs = fs
        self.f0_dim_index = f0_dim_index
        self.seed, self.mode = seed, mode
        self.engine, self.quantize = engine, quantize
        self._streams = {}              # (maxd bucket, chunk) -> session

    # ---- loading ----

    @classmethod
    def load(cls, path: str, checkpoint: Union[None, int, str] = None,
             stats: Union[None, str, Scaler] = None, **kw) -> "Vocoder":
        """path: an experiment directory holding `model.conf` (and by
        default `checkpoint-final.pkl`), or the model.conf path itself.
        checkpoint: an iteration number (-> `checkpoint-<N>.pkl`), a path,
        or None for `checkpoint-final.pkl`; a `.pkl` that is missing falls
        back to its `.orbax` twin.  stats: the corpus stats h5 (or a
        Scaler) that standardizes raw WORLD features; omit it only for
        features that are already standardized.  Reads either backend's
        checkpoints written by either package."""
        from qpnet_tpu_torch.models.qpnet import params_from_numpy
        from qpnet_tpu_torch.train.checkpoint import load_checkpoint

        conf = path if path.endswith(".conf") else os.path.join(
            path, "model.conf")
        expdir = os.path.dirname(conf) or "."
        run_cfg = RunConfig.load(conf)
        if checkpoint is None:
            ckpt_path = os.path.join(expdir, "checkpoint-final.pkl")
        elif isinstance(checkpoint, int):
            ckpt_path = os.path.join(expdir, f"checkpoint-{checkpoint}.pkl")
        else:
            ckpt_path = checkpoint
        device = resolve_device(kw.get("device", "cuda"))
        params = params_from_numpy(load_checkpoint(ckpt_path)["model"],
                                   device)
        if isinstance(stats, str):
            scaler = load_scaler(stats, run_cfg.feature_type)
        else:
            scaler = stats
        kw.setdefault("fs", run_cfg.fs)
        return cls(params, run_cfg.model, scaler, **kw)

    # ---- conditioning (the qpnet_decode contract) ----

    def conditioning(self, feats: np.ndarray, f0_factor: float = 1.0):
        """Raw WORLD aux features (F, n_aux) -> (standardized h float32,
        frame-rate dilation factors d float32), with the F0 column scaled
        by f0_factor and d computed from the scaled track."""
        feats = np.array(feats, np.float64)
        if feats.ndim != 2 or feats.shape[1] != self.cfg.n_aux:
            raise ValueError(
                f"feats must be (F, {self.cfg.n_aux}), got {feats.shape}")
        if feats.shape[0] == 0:
            raise ValueError("empty conditioning (0 frames)")
        feats[:, self.f0_dim_index] *= f0_factor
        d = dilated_factor(
            np.ascontiguousarray(feats[:, self.f0_dim_index]),
            self.fs, self.cfg.dense_factor)
        h = self.scaler.transform(feats)
        return h.astype(np.float32), d.astype(np.float32)

    # ---- analysis frontend (wav -> conditioning features) ----

    def analyze(self, wav: np.ndarray, minf0: float = 40.0,
                maxf0: float = 400.0, f0_analyzer: str = "harvest",
                dsp_backend: str = "jax") -> np.ndarray:
        """One utterance's waveform -> raw `/world`-schema aux features
        (F, n_aux) = [uv | cont-F0(20 Hz LPF) | mcep | codeap], what
        `feature_extract` writes and `synthesize()` conditions on.

        The feature geometry (mcep dim/alpha, fftl, shift) comes from the
        fs-keyed AcousticConfig table, as in the training recipe.  `wav`
        may be float in [-1, 1) (the synthesize() output convention) or
        int16-scale; analysis runs at int16 scale, like the recipe.
        dsp_backend="jax" (the JAX package's value; here: on the torch
        device) runs the fused device pass on the vocoder's device
        (WorldAnalyzer.extract_all); "numpy" is the float64 host path."""
        from qpnet_tpu_torch.config import AcousticConfig
        from qpnet_tpu_torch.dsp import low_cut_filter
        from qpnet_tpu_torch.dsp.contf0 import smoothed_continuous_f0
        from qpnet_tpu_torch.dsp.world import WorldAnalyzer

        ac = AcousticConfig(fs=self.fs, minf0=minf0, maxf0=maxf0)
        in_dtype = np.asarray(wav).dtype
        was_integer = np.issubdtype(in_dtype, np.integer)
        x = np.asarray(wav, np.float64)
        if x.ndim != 1:
            raise ValueError(f"wav must be 1-D, got {x.shape}")
        if x.size == 0:
            raise ValueError("empty waveform (0 samples)")
        # integer PCM is rescaled from its container's full-scale range to
        # int16 scale (int16 passes through; unsigned PCM is offset-binary,
        # so its midpoint is removed first); a float whose peak is <= 1.0
        # is taken as a normalized clip and rescaled, a larger one passes
        # through — pre-scale a quiet int16-scale float
        if was_integer and in_dtype != np.int16:
            info = np.iinfo(in_dtype)
            if info.min == 0:
                x = x - (float(info.max) + 1.0) / 2.0
            x = x * (32768.0 / ((float(info.max) + 1.0)
                                / (2.0 if info.min == 0 else 1.0)))
        elif not was_integer and np.abs(x).max() <= 1.0:
            x = x * 32768.0
        if ac.highpass_cutoff:
            x = low_cut_filter(x, self.fs, cutoff=ac.highpass_cutoff)
        analyzer = WorldAnalyzer(
            fs=self.fs, shiftms=ac.shiftms, minf0=minf0, maxf0=maxf0,
            fftl=ac.fftl, f0_analyzer=f0_analyzer, backend=dsp_backend,
            f0_backend="jax" if dsp_backend == "jax" else "host",
            device=self.device)
        if dsp_backend == "jax":
            out = analyzer.extract_all(x, dim=ac.mcep_dim,
                                       alpha=ac.mcep_alpha)
            f0, mcep, codeap = out["f0"], out["mcep"], out["codeap"]
        else:
            f0, _, _ = analyzer.analyze(x)
            mcep = analyzer.mcep(dim=ac.mcep_dim, alpha=ac.mcep_alpha)
            codeap = analyzer.codeap()
        uv, cont_f0_lpf = smoothed_continuous_f0(f0, ac.shiftms)
        feats = np.concatenate(
            [uv[:, None], cont_f0_lpf[:, None], mcep, codeap], axis=1)
        if feats.shape[1] != self.cfg.n_aux:
            raise ValueError(
                f"analysis produced {feats.shape[1]}-dim features but the "
                f"model expects n_aux={self.cfg.n_aux}; the model was "
                "trained with a non-default feature geometry — extract "
                "features with the training recipe instead")
        return feats.astype(np.float32)

    def vocode(self, wav: np.ndarray, f0_factor: float = 1.0,
               **analyze_kw) -> np.ndarray:
        """wav in, re-vocoded wav out: analyze() then synthesize(), with
        optional F0 scaling (the reference recipe decodes at F0 x0.5 and
        x1.5).  By default both halves run on the vocoder's device."""
        return self.synthesize(self.analyze(wav, **analyze_kw),
                               f0_factor=f0_factor)

    # ---- one-shot synthesis ----

    def synthesize(self, feats: np.ndarray, f0_factor: float = 1.0
                   ) -> np.ndarray:
        """One utterance: raw aux features (F, n_aux) -> float32 waveform in
        [-1, 1), F*upsampling_factor - 1 samples (the decode CLI's count)."""
        return self.synthesize_batch([feats], f0_factor=f0_factor)[0]

    def synthesize_batch(self, feats_list: Sequence[np.ndarray],
                         f0_factor: float = 1.0) -> List[np.ndarray]:
        """Batch synthesis through the vocoder's engine, one batch for all
        utterances.  They may differ in length; outputs come back in input
        order."""
        from qpnet_tpu_torch.models.generate import batch_fast_generate

        cfg = self.cfg
        up = cfg.upsampling_factor
        conds = [self.conditioning(f, f0_factor) for f in feats_list]
        B = len(conds)
        F_max = max(h.shape[0] for h, _ in conds)
        h_pad = np.zeros((B, F_max, cfg.n_aux), np.float32)
        d_pad = np.zeros((B, F_max * up), np.float32)
        n_samples = []
        for i, (h, d) in enumerate(conds):
            h_pad[i, : h.shape[0]] = h
            d_pad[i, : h.shape[0] * up] = np.repeat(d, up)
            n_samples.append(h.shape[0] * up - 1)
        x0 = np.full((B, 1),
                     int(encode_mu_law(np.zeros(1), cfg.n_quantize)[0]),
                     np.int32)
        samples = batch_fast_generate(
            self.params, cfg, x0, h_pad, n_samples, d_pad,
            seed=self.seed, mode=self.mode, engine=self.engine,
            quantize=self.quantize, device=self.device)
        return [np.asarray(decode_mu_law(s, cfg.n_quantize), np.float32)
                for s in samples]

    # ---- streaming synthesis ----

    def stream(self, feats: np.ndarray, f0_factor: float = 1.0,
               chunk_samples: int = 5500, maxd: Optional[int] = None
               ) -> Iterator[np.ndarray]:
        """Yield float32 audio chunks while the card generates them (the
        first after one chunk, constant memory for any length).  Total
        audio is F*upsampling_factor samples.  Sessions are cached per
        (maxd bucket, chunk_samples) and reused across calls with fresh
        ring state; for many concurrent streams use
        qpnet_tpu_torch.serve.StreamingService, which batches them into one
        kernel."""
        from qpnet_tpu_torch.models.generate import (StreamingGenerator,
                                                     bucket_maxd)

        cfg = self.cfg
        h, d = self.conditioning(feats, f0_factor)
        bucket = bucket_maxd(float(d.max())) if maxd is None else maxd
        key = (bucket, chunk_samples)
        sess = self._streams.get(key)
        if sess is None:
            sess = StreamingGenerator(
                self.params, cfg, B=1, maxd=bucket, seed=self.seed,
                mode=self.mode, min_chunk_samples=chunk_samples,
                quantize=self.quantize, device=self.device)
            self._streams[key] = sess
        else:
            sess.reset(seed=self.seed)
        Fc = sess.chunk_frames
        F = h.shape[0]
        for start in range(0, F, Fc):
            end = min(start + Fc, F)
            h_blk, d_blk = h[start:end], d[start:end]
            if end - start < Fc:                     # pad the tail chunk
                pad = Fc - (end - start)
                h_blk = np.concatenate([h_blk, np.repeat(h_blk[-1:], pad, 0)])
                d_blk = np.concatenate([d_blk, np.repeat(d_blk[-1:], pad)])
            out = sess.feed(h_blk[None], d_blk[None])[0]
            take = min((end - start) * cfg.upsampling_factor, out.shape[0])
            yield np.asarray(
                decode_mu_law(out[:take], cfg.n_quantize), np.float32)

    # ---- convenience ----

    def synthesize_to_wav(self, feats: np.ndarray, path: str,
                          f0_factor: float = 1.0) -> str:
        """Synthesize and write an int16 wav at the vocoder's fs (the decode
        CLI's conversion: clip to +-32768)."""
        from scipy.io import wavfile

        wav = self.synthesize(feats, f0_factor=f0_factor)
        pcm = np.clip(wav * 32768, -32768, 32767).astype(np.int16)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        wavfile.write(path, self.fs, pcm)
        return path
