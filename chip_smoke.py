#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qpnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each reported on its own line; any failure exits non-zero:
  1. card: nvidia-smi name and power limit, torch's device name;
  2. build: every CUDA source of the port, with nvcc, in parallel;
  3. the generation kernel (K1) against its plain PyTorch twin on the card,
     at the default network's full width (random weights from a seed),
     B=8, 4 frames: forced logits of the kernel and of the f32 twin each
     against the twin summed in float64 (the kernel's max |dlogit| at most
     max(2e-2, twice the f32 twin's); argmax agreement with the f32 twin
     >= 0.98), argmax and sampling (first sample equal, 40-sample agreement
     >= 0.85), sampling determinism, and 2+2-frame chunks bit-identical to
     one 4-frame call;
  4. the main path: `batch_fast_generate` at B=20 (the reference decode
     batch) on utterances of 0.5-1.0 s with varying F0, sampling with seed
     100, to int16 wavs; K1 must have been launched;
  5. one K1 call at B=20, maxd 48, 4 frames: forced logits on phase 3's
     f64 gate, then timed against the twin and its bound, with the host
     launches per step and the device time by CUDA kernel and idle share;
  6. the training kernels (K2 forward and backward) against their twins at
     the default network's full width, B=1, T=30030, with an F0 track in
     80-300 Hz: f32 and bf16, fixed layers only and with the adaptive
     layers fused; f32: every output within 1e-4 of the f32 twin's as
     max |d| / max |ref|; bf16 (tensor-core sums in no IEEE order): every
     output of the kernel and of the f32-summing twin against the twin
     summed in float64, the kernel's within max(2e-2, twice the f32
     twin's); the fixed-only backward bit-identical when repeated;
  7. the training main path: `train_loop` with the kernel engine, f32,
     B=1, windows of the batcher over an in-memory corpus at 22,050 Hz,
     4 steps; both K2 kernels launched, finite losses, checkpoint and loss
     record written and read back; the trained state written again through
     the orbax backend (`checkpoint-4.orbax`, `checkpoint-final.orbax`, the
     plain layout) and read back, every leaf equal to the pickles' bit for
     bit and Adam's count 4, then `Vocoder.load` of the `.orbax` final
     decoding 2 frames at B=1 through K1 in argmax, samples equal bit for
     bit to the same decode from the pickle (K1's launches go into
     `launches_by_path["orbax_decode"]`); the committed JAX orbax fixture
     (`tests/data/orbax_fixture`, OCDBT, zstd-coded) read equal to its
     pickle twin, the host C++ zstd decoder equal to the plain Python one
     on every frame in it (manifest, b-tree nodes, chunks); save and load
     walls and the C++ decoder's MB/s; then one step's loss and gradients with
     each engine from the same parameters and batch: losses within 1e-4,
     and each gradient leaf of the kernel engine no farther from the
     plain engine's f64 gradient than max(1e-3, twice the plain f32
     engine's worst leaf), as max |d| / max |ref|;
  8. times: K2 forward and backward per call (f32, bf16) with their
     TFLOP/s, bounds, twins, device ms by CUDA kernel (torch.profiler) and
     the same call's products alone through torch.matmul (a yardstick the
     port never calls), and the training step with each engine;
  9. K1's w8a8 branch and K1-bf16 against their twins at the full width of
     the deep Rd10Rr3Ed4Er1 network (34 layers, random weights from seed
     0), B=7 (its reference decode batch), maxd 48, 2 frames: K1-w8a8's
     forced logits, sampled samples, rings and x equal to its twin's bit
     for bit; K1-bf16 on phase 3's f64 gate and sampling agreement (its
     sampling twin over the first frame, which holds the first 40); w8a8
     against bf16 forced logits: relative RMSE < 0.10, argmax agreement >
     0.90; K1-w8a8 bit for bit against its twin at the sessions' B=8;
 10. the serving main path: `StreamingService` on the deep net at w8a8
     (maxd 48, 7 streams, session B=8, 5500-sample chunks after a
     1100-sample first chunk) behind `serve_tcp` on 127.0.0.1, 7
     concurrent `request_stream` clients with 0.5-1.0 s utterances (F0
     80-300 Hz, 10% unvoiced): in argmax mode gathered into one group, each
     stream's PCM equal to one direct `StreamingGenerator`'s; then in
     sampling mode, each stream's time to first audio and realtime factor;
     K1-w8a8 must have been launched;
 11. times: K1 ms/step on the deep net, bf16 and w8a8, at B=7 and B=64,
     beside the bound, the twin, the host launches per step and the device
     time by CUDA kernel and idle share;
 12. the scan engine (plain PyTorch, no kernel) at the default network's
     full width, B=8, 4 frames, d interpolated between frames (so it varies
     within frames, maxd bucket 48): `engine="auto"` must take the scan (K1
     not launched), sampling twice with one seed bit-identical; forced
     logits of the f32 scan within 1e-4 of scale of the f32 forward
     replayed over the same stream, int8_weights against bf16 relative
     RMSE < 0.10 and argmax agreement > 0.90, bf16 against f32 argmax
     agreement >= 0.98; a bf16 argmax run replayed through the forward
     agrees on >= 0.85 of its first 40 samples; then scan ms/step at B=8
     and 20 in f32, bf16 and int8_weights (median, lowest and highest of
     3 calls of one frame each) beside K1's us/step;
 13. validation over in-memory windows (`qpnet_validate.validation_loss`
     equal to the mean of `make_eval_step`'s losses; two appends of the
     result file read back), and a synthetic reference state_dict at the
     default widths through `convert_checkpoint.main`: leaves equal to
     `convert_state_dict`'s bit for bit, loaded onto the card and decoded
     for 2 frames through K1 (launched, outputs finite);
 14. `tools/serve_soak.run_soak` on the default network, bf16, 8 streams,
     a quarter of a minute of 1.0 s utterances: ok, completions, K1
     launched; its
     summary JSON, prewarmed group sizes and chunk latencies;
 15. WORLD analysis on the card at the port's AcousticConfig (22,050 Hz,
     fftl 1024, mcep 34, alpha 0.455, 5 ms, harvest 40-400 Hz) on
     synthetic voiced 3 s and 10 s utterances, its sequential stages
     through the kernels W1-W4 (`ops/world_kernel.py`: pooling, Viterbi,
     DIO's contour walks, smoothing): each kernel against its plain
     version bit for bit on the inputs the passes gave it (recorded at the
     wrappers), timed beside it, the first design's recorded time (a thread
     a frame, one warp a Viterbi or a DIO walk, one bin a thread), its
     bound (bytes, or operations at half the fused float32 rate: the file
     is built -fmad=false), W2's and W3's chain probe (a minimal step at
     every frame of the same chain), W1's and W3's empty launch with their
     grid and (W4) a grouped conv1d; every kernel also bit for bit on the
     CPU tests' edge inputs (`ops/world_kernel_cases.py`: ties, NaN,
     +-inf, 1e30, the tile remainders; W1's 5% edge, tiny and agreeing
     +inf candidates at 1-97 ranks and K 1-16; W3's 10% edge at C = 1-32,
     F = 1 and 2, all-voiced and all-unvoiced; W1 and W3 four calls each),
     W2 at its shared-memory capacity and past it (the spill branch,
     kernel only: S = 16 at 15,001 and 6,001 frames, S = 7 at 12,001 and
     11,800, four calls each), W3 four times on the input of a DIO F0 pass
     over the 10 s utterance (device_dio alone), timed, and past its
     shared memory (6,500 frames at C = 7, 2,001 at C = 32, walked on
     device memory), timed; the wide branches (`wk_wide`: W1 past 16
     slots, W2 past 16 states, W3 past 32 candidates) four calls each on
     the CPU tests' wide inputs (K 17-255, S 17-256 with one past the
     back-pointers' shared memory, C 33-256 staged and on device memory),
     on the inputs of a device_harvest(max_candidates=31) pass and of
     device_dio passes at 12 and 73 bands an octave (C = 42, 256) over the
     3 s utterance, the first two queued and counted, their F0 on the JAX
     package's gates against the host's harvest and dio + stonemask, and
     timed beside their plain versions (W1, W2 at K = 31 and 127 on 10 s
     inputs, W3 at C = 42 and 256 on the 3 s DIO inputs);
     `WorldAnalyzer.extract_all` queued without a sync
     (`torch.cuda.set_sync_debug_mode("error")`), the kernels' launches
     counted over that pass, its F0 held to the host
     analysis with the JAX package's gates (voicing agreement > 0.85, both
     voiced > 0.4, median |dF0| < 1 Hz, > 0.9 within 10 Hz); the device
     spectral stages fed the host F0 against the host's (CheapTrick median
     < 0.01 dB, mean < 0.05 dB; mcep c0 mean < 0.1, mean < 0.05; codeap
     median < 0.01 dB and under 1% of its values beyond 0.1 dB); fused
     equal to staged (F0 bit for bit, mcep within 1e-5, codeap and npow
     1e-4); the max gates (D4C < 0.05 dB, codeap < 0.1 dB) on the JAX
     package's own gate inputs (`dsp/world/gates.py`); ms per second of
     audio (device: median, lowest and highest of 5 passes after a
     warm-up, each split by stage from its own CUDA events; host once),
     CUDA kernels per utterance, idle share, peak memory; the same with
     `f0_analyzer="dio"` (device DIO and StoneMask, W3) on the 3 s
     utterance, its F0 on the same gates against the host's dio and
     stonemask, 3 passes timed; then K1 held
     against its twins in forced mode at the shape `vocode` gives it (B=1,
     the utterance's maxd bucket, 4 frames around its largest d), and
     `Vocoder(device="cuda").vocode` of the 3 s utterance as int16 PCM on
     the default net (random weights, a scaler from its own features):
     F*up - 1 finite, non-silent samples, K1 launched; its wall time beside
     `analyze` of the same PCM timed alone.
 16. the recipe's workers on a synthetic corpus (4 int16 voiced utterances
     of 1.0-2.0 s, 22,050 Hz, seed 16): `feature_extract.main` with the
     host backends through 2 spawned workers, with both device backends on
     the card (the fused pass, pipelined at depth 2) and with the device
     spectral stages fed the host F0 from 2 threads: h5 schemas equal,
     the fused F0 on phase 15's gates, the staged features on its spectral
     gates; `calc_stats.main` within 1e-12 of one float64 batch;
     `noise_shaping.main` equal to `emphasize` of each wav, and 0.25 s of
     MLSA through the C++ core within 1e-12 of scale of the plain
     per-sample loop; the restore pass on the card (`--inv false
     --dsp_backend jax`): one utterance queued under
     `set_sync_debug_mode("error")`, pulse times (index plus fractional
     shift) within 1e-6 sample of the host's, the
     ap = 0 waveform on the JAX package's gates (correlation > 0.999, rms
     |d| < 5e-3 of rms), MCD on the JAX test's restore inputs at most the
     host's seed-to-seed floor + 0.1 dB; K1 against its twins in forced
     mode at the decode's shape (B=4, the features' maxd bucket, 2 frames
     around the largest d, on phase 3's f64 gate), then `qpnet_decode.main`
     of the 4 feature files at B=4 through K1 (default net, random weights
     seed 0; launched), `noise_restored.main` equal to `emphasize` of each
     decoded wav; then K1 against its twins likewise at the serving
     session's shape (B=4, its maxd), and the default net at bf16 behind
     `serve_tcp` with the serve CLI's own `--noise_shaping` filter and
     frontend, 3 TCP streams of 100 frames: argmax PCM equal to a direct
     `StreamingGenerator` through one-shot `emphasize`; sampling time to
     first audio and realtime factor with and without the filter; times
     (extraction, shaping and synthesis ms per second of audio, host and
     device; the filter's ms per 5,500-sample chunk beside K1's feed of
     it); the port's HDF5 on the recipe's feature files (write_hdf5 and
     read_hdf5 ms per call and MB/s, each dataset read back bit for bit);
     then the h5py-written fixture (tests/data/h5_fixture): every dataset
     read bit for bit against its .npz twin, each file written again by
     the port's write_hdf5 and read back equal, K1 against its twins at
     its decode's shape (B=2) and `qpnet_decode.main` of its two feature
     files with its stats through K1 (launched; wavs of F*up - 1
     samples).  K1's launches go into the `kernels` line's
     `launches_by_path` as "recipe", "serve_ns" and "h5_fixture".  Every
     h5 file of phases 16-18 is HDF5, read and written by the port's
     `data/hdf5_format.py`, which needs no h5py.
 17. the synthetic recipe (qpnet_tpu_torch/recipes/run_synth.sh's stages
     c f t a d s e, in process, with the argv the script gives and the
     device analysis; runFE with 2 host worker processes, runQP's
     restoration inline): `make_synth_corpus` (1
     speaker, 22,050 Hz, 6 + 8 + 4 training and 4 evaluation utterances,
     --seconds 1.5, seed 0), `runFE -1` on the training list (histograms),
     `runFE -2` of both lists on the card, `-3`, `-4`; `runQP -1` (SI, 100
     iterations, bf16, the default network at full width, the plain engine:
     K2 not launched), `-2` (SD, 100 iterations), `-5` (the sweep prints
     best iteration 100); K1 against its twins in forced mode at the
     decode's shape (B=4, the extracted features' maxd bucket, random
     weights, on phase 3's f64 gate); `-r -3 -4` of the SD model at
     that iteration, `-m -r -3 -4` of the SI model and `-m -r -F 1.5 -3 -4`,
     each launching K1; the experiment directories, checkpoints,
     model.conf, loss and validation records, and every wav under
     noiseshaped/ and restored/ with F*up - 1 samples; finite losses;
     `evaluate` of the restored wavs against the source wavs (printed, not
     gated: 100 iterations set no quality bar); each stage's wall and peak
     device memory.  K1's launches go into `launches_by_path["run_synth"]`.
 18. data parallelism on the one card, two shards or ranks sharing it:
     K1 at the shard's shape (B=10 of phase 4's batch, the frame of the
     largest d) against its twins in forced mode on phase 3's f64 gate,
     and at b_offset = 10 in argmax and sampling (`sample_check`) and bit
     for bit against the same rows of one B=20 call; then the main path:
     `batch_fast_generate(mesh=Mesh(["cuda:0"] * 2))` on phase 4's inputs
     and seed, samples equal to phase 4's single call bit for bit in
     sampling, and to a single call in argmax; the deep net at w8a8: K1-w8a8
     at b_offset = 4 (B=4 of a B=8 batch) bit for bit against its twin in
     argmax and sampling and against the same rows of one B=8 call, then
     the batch as 2 x 4 through `batch_fast_generate`, equal to one B=8
     call; then two `qpnet_train` processes
     joined as two hosts (--coordinator 127.0.0.1:<free port> --n_hosts 2
     --host_id 0/1, --device cuda --fixed_engine pallas, default net, f32,
     global batch 2, phase 7's window, 4 iterations, a 4-utterance corpus
     of wav and h5 files): both log the same losses, the trainer's
     all-gathered parameter checksum is equal on both, only host 0 wrote
     checkpoints, the log names gloo as the gradients' backend (the ranks
     share the card), K2 launched on each; beside them, started with
     them, a second pair where QPNET_PREEMPT_AFTER=3 on host 0 only
     (plain engine, a 3,300-sample window) stops both hosts at iteration 4
     with checkpoint-4.pkl and no checkpoint-final.pkl.
     Walls, ms per iteration beside phase 8's one-process step, the
     all-reduce's ms per step and peak device memory per rank.  K1's
     launches go into `launches_by_path["dp_decode"]` (both branches), the
     ranks' K2 launches into the K2 rows' `launches_by_path["dp_train"]`.
 19. deep-net training: K2 against its twins at the Rd10Rr3Ed4Er1
     geometry (30 fixed layers, dilations 1-512, at full width; random
     weights from seed 0) on the first window of the deep tool's corpus
     (B=1, T=22,550, the registry's padded max_length), on phase 6's
     gates, f32 and bf16, fixed layers only (the tool's path) and with the
     4 adaptive layers fused at the corpus's maxd bucket (the trainer's
     QPNET_FUSE_ADAPTIVE path); K2's times there (fixed only, f32 and
     bf16) beside their bounds, twins and the products through
     torch.matmul, with device ms by CUDA kernel; then the main path:
     `tools/deep_train_smoke.train_run` in bf16 for DEEP_ITERS iterations
     through the kernel engine (K2 launched on every step) and through
     the plain engine (K2 not launched), each passing the tool's loss gate,
     with ms per step and peak device memory.  K2's launches go into the
     K2 rows' `launches_by_path["deep_train"]`.
 20. tensor parallelism on the one card: (dp=1, tp=2) as two gloo ranks
     on cuda:0, the default net at full width, f32, the plain engine, 4
     steps on 3,300-sample windows of phase 7's corpus, beside one process
     on the same batches: losses within rtol 2e-5, step 1's gradients
     within 1e-4 of each leaf's norm from the float64 gradient, each
     rank's W_cur holding 2R/2 paired columns, and the checkpoint the
     ranks gather equal in layout to the one process's; the final
     parameters' distance from one process's printed, not gated; ms per
     step beside phase 8's.  Phases 20-22 run their legs in one spawn of
     four ranks (`dryrun.run_legs`); no kernel runs on these paths (the
     plain engine, as in JAX under a mesh).  Each prints the post-net
     ReLU inputs that one process's f32 forward puts on the other branch
     from float64 (`kink_line`);
 21. sequence parallelism on the one card: (dp=1, sp=2) and (dp=1, tp=2,
     sp=2) as two and four gloo ranks, phase 20's batches and one process:
     losses within rtol 2e-5, step 1's gradients within 1e-4 of each
     leaf's norm from the float64 gradient at float64's ReLU branches or,
     every leaf, at one process's f32 branches (float64 sums over the
     branches an f32 forward takes where a post-net input lies within
     rounding of 0), each rank's x holding T/2 samples, each block's
     agreed halo (printed beside maxd*dil) no longer than that bound; ms
     per step beside one process's;
 22. pipeline parallelism on the one card: (dp=1, pp=2) GPipe over 2
     microbatches of B=2 windows of 3,300 samples as two gloo ranks,
     beside one process on the same batches: the last stage's logits
     against one process's forward (bit-equal or not, printed), losses
     within rtol 1e-5, step 1's gradients within 1e-4 of each leaf's norm
     from the float64 gradient as in phase 21; the bubble share and ms
     per step.
Each main path (phases 4, 7, 10, 12-19) also prints its peak device memory.
After phase 22 a line gives the script's wall by phase beside its limit
(TIME_LIMIT_S, 750 s on one H100).  Then one JSON line describing each kernel, and as the last line
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device, and
imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

FS = 22050
# bf16: the kernel's tensor cores sum W_in and W_out in their own order,
# so its forced logits are held to the plain twin summed in float64: their
# max |dlogit| may be at most max(F64_TOL, 2 x the f32 twin's own), and
# their argmax must agree with the f32 twin's on ARGMAX_AGREE_MIN of the
# (step, row) pairs.  w8a8 (exact int32 sums, f64 post-net) equals its
# twin bit for bit.
F64_TOL = 2e-2
ARGMAX_AGREE_MIN = 0.98
AGREE_MIN = 0.85             # argmax/sampling agreement over 40 samples


T_START = time.perf_counter()
TIME_LIMIT_S = 750   # this script's wall on one card, the build included


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def make_inputs(rng, cfg, frames):
    """(x, h, n_samples, d) as the decode CLI builds them: one mu-law zero
    seed, standardized aux, frame-constant d from an F0 track."""
    from qpnet_tpu_torch.bench import f0_track
    from qpnet_tpu_torch.ops import dilated_factor
    B, F = len(frames), max(frames)
    up = cfg.upsampling_factor
    h = np.zeros((B, F, cfg.n_aux), np.float32)
    d = np.ones((B, F * up), np.float32)
    for i, f in enumerate(frames):
        h[i, :f] = rng.normal(size=(f, cfg.n_aux))
        d[i, :f * up] = np.repeat(
            dilated_factor(f0_track(rng, f, unvoiced=0.1), FS,
                           cfg.dense_factor), up)
    x = np.full((B, 1), cfg.n_quantize // 2, np.int32)
    return x, h, [f * up - 1 for f in frames], d


def forced_check(K, common, kw, xf, tag):
    """Forced logits of K1 against its twins on the same inputs; returns
    (max |dlogit| to the yardstick, plain twin ms).  bf16: the kernel and
    the f32 twin each against the twin summed in f64 (the gate above);
    w8a8: logits, rings and x equal to the twin's bit for bit."""
    import torch
    k_out = K.generate(*common, **kw, mode="forced", x_forced=xf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r_out = K.generate_reference(*common, **kw, mode="forced", x_forced=xf)
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(k_out[0]).all()), f"{tag} forced logits finite")
    check(torch.equal(k_out[3], r_out[3]), f"{tag} forced x state")
    scale = float(r_out[0].abs().max())
    if kw.get("quantize", "none") == "w8a8":
        err = float((k_out[0] - r_out[0]).abs().max())
        same = all(torch.equal(a, b) for a, b in zip(k_out, r_out))
        phase(tag, f"forced {kw['n_steps']} steps: max |dlogit| to the twin "
                   f"{err:.3e} at logit scale {scale:.3f}; logits, rings and "
                   f"x equal bit for bit: {same}")
        check(same, f"{tag} forced run must equal its twin bit for bit")
        return err, twin_ms, k_out[0]
    r64 = K.generate_reference(*common, **kw, mode="forced", x_forced=xf,
                               f64_sums=True)[0]
    err = float((k_out[0] - r64).abs().max())
    twin_err = float((r_out[0] - r64).abs().max())
    agree = float((k_out[0].argmax(-1) == r_out[0].argmax(-1)).float().mean())
    ring_err = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(k_out[1:3], r_out[1:3]))
    tol = max(F64_TOL, 2 * twin_err)
    phase(tag, f"forced {kw['n_steps']} steps: max |dlogit| to the f64 twin "
               f"{err:.3e} (tol {tol:.3e}; the f32 twin's {twin_err:.3e}), "
               f"logit scale {scale:.3f}, argmax agreement with the f32 twin "
               f"{agree:.4f} (min {ARGMAX_AGREE_MIN}), ring max |d| "
               f"{ring_err:.3e}, x equal")
    check(err <= tol, f"{tag} forced logits {err} > {tol} from the f64 twin")
    check(agree >= ARGMAX_AGREE_MIN, f"{tag} argmax agreement {agree}")
    return err, twin_ms, k_out[0]


def path_shape_check(K, params, cfg, h, d, frames, rng, dev, tag):
    """K1 against its twins in forced mode (`forced_check`) at the shape a
    path gives it: h (B, F, n_aux) standardized aux and d (B, F) frame-rate
    dilation factors as the path builds them, at the maxd bucket of all of
    d, over `frames` frames around its largest value, the rings primed
    from a mid-scale seed and the window's first frame.  Returns the max
    |dlogit| to the f64 twin and the maxd bucket."""
    import torch
    from qpnet_tpu_torch.models import generate as G
    from qpnet_tpu_torch.ops import encode_mu_law
    B, F = d.shape
    up = cfg.upsampling_factor
    i = max(0, min(int(np.argmax(d.max(0))), F - frames))
    n_k = frames * up
    x = np.full((B, 1), int(encode_mu_law(np.zeros(1), cfg.n_quantize)[0]),
                np.int32)
    maxd, x_seed, d_gen = G._seed_and_d(
        cfg, x, np.repeat(d[:, i:i + frames], up, axis=1), n_k)
    want = G.bucket_maxd(float(np.nanmax(np.ceil(d))))
    check(maxd == want, f"{tag}: maxd bucket {maxd} != {want}")
    h_pad, d_fr, _ = G._pallas_host_prep(cfg, h[:, i:i + frames], d_gen,
                                         n_k, dev)
    h_pad, d_fr = h_pad[:frames], d_fr[:frames]
    packed, bufF0, bufA0, x0 = G._prologue(
        params, cfg, torch.as_tensor(x_seed, device=dev), h_pad[0], maxd,
        const_seed=True)
    phase(tag, f"K1 at the path's shape: B={B}, maxd bucket {maxd} (d "
               f"{d.min():.3f}-{d.max():.3f}), frames {i}-{i + frames - 1} "
               f"of {F}")
    xf = torch.as_tensor(rng.integers(0, cfg.n_quantize, (n_k, 1, B)),
                         dtype=torch.int32, device=dev)
    err, _, _ = forced_check(K, (packed, cfg, bufF0, bufA0, x0, h_pad, d_fr,
                                 7), dict(B=B, maxd=maxd, n_steps=n_k), xf,
                             tag)
    return err, maxd


def sample_check(K, common, kw, tag):
    """Argmax and sampling against the twin: bit for bit in w8a8; in bf16
    the first sample equal and the 40-sample agreement >= AGREE_MIN."""
    import torch
    for mode in ("argmax", "sampling"):
        k_out = K.generate(*common, **kw, mode=mode)
        r_out = K.generate_reference(*common, **kw, mode=mode)
        ks, rs = (o[0][:, 0].T.cpu().numpy() for o in (k_out, r_out))
        agree = float((ks[:, :40] == rs[:, :40]).mean())
        same = all(torch.equal(a, b) for a, b in zip(k_out, r_out))
        phase(tag, f"{mode}: first sample equal "
                   f"{bool((ks[:, 0] == rs[:, 0]).all())}, 40-sample "
                   f"agreement {agree:.3f}, all-step agreement "
                   f"{float((ks == rs).mean()):.3f}, samples, rings and x "
                   f"equal {same}")
        if kw.get("quantize", "none") == "w8a8":
            check(same, f"{tag} {mode} must equal its twin bit for bit")
        check(bool((ks[:, 0] == rs[:, 0]).all()), f"{tag} {mode} first sample")
        check(agree >= AGREE_MIN, f"{tag} {mode} agreement {agree}")


def launch_line(K, cfg, n_steps):
    """The host launches and device kernels per step of one K1 call."""
    h = K.host_launches(cfg, n_steps)
    return (f"host launches {h['host_launches']} per call = "
            f"{h['host_launches'] / n_steps:.4f} per step (1 context kernel "
            f"and 1 graph replay per frame), {h['kernels_per_step']} CUDA "
            f"kernels per step in the graph")


def prof_line(prof):
    """Device time per step by kernel and the device idle share."""
    per_kernel, idle = prof
    if per_kernel is None:
        return "device time by kernel: not measured (the profiler saw none)"
    return ("device us/step by kernel (kernels overlap under programmatic "
            "dependent launch): " + ", ".join(
                f"{k} {v:.2f}" for k, v in sorted(per_kernel.items(),
                                                   key=lambda kv: -kv[1]))
            + f"; device idle share {idle:.4f}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from qpnet_tpu_torch.bench import card as card_line
        from qpnet_tpu_torch.config import ModelConfig
        from qpnet_tpu_torch.ops import _build
        from qpnet_tpu_torch.ops import gen_kernel as K
        from qpnet_tpu_torch.ops import train_kernel as TK
        from qpnet_tpu_torch.ops import world_kernel as WK
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "f32 products must not run in TF32")

    # 1. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase("card", f"{card} | torch {torch.__version__} cuda "
                  f"{torch.version.cuda} | {kind}")
    dev = torch.device("cuda")

    # 2. build every source in parallel (one nvcc each)
    t0 = time.perf_counter()
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    host = sorted(p.stem for p in _build.CSRC.glob("*.cpp"))
    with ThreadPoolExecutor(len(names) + len(host)) as ex:
        libs = [ex.submit(_build.build, n, verbose=True) for n in names]
        libs += [ex.submit(_build.build_host, n) for n in host]
        libs = [f.result() for f in libs]
    K.build()
    TK.build()
    WK.build()
    phase("build", f"{len(libs)} source(s) {names} with nvcc and {host} "
                   f"with the host C++ compiler built in "
                   f"{time.perf_counter() - t0:.2f} s")

    laps = [("start", T_START), ("build", time.perf_counter())]

    def lap(label):
        laps.append((label, time.perf_counter()))
    kernels, case4 = smoke(ModelConfig(), dev, card)
    lap("3-5")
    extra = {}
    kernels += train_smoke(ModelConfig(), dev, card, extra=extra)
    lap("6-8")
    kernels.insert(1, deep_main(dev, card))
    lap("9-11")
    scan_smoke(ModelConfig(), dev, card)
    lap("12")
    kernels[0]["launches_by_path"] = {
        "decode": kernels[0]["launches"],
        "orbax_decode": extra["orbax_k1_launches"],
        "converted_decode": tools_smoke(ModelConfig(), dev, card)}
    lap("13")
    kernels[0]["launches_by_path"]["soak"] = soak_smoke(dev, card)
    lap("14")
    kernels[0]["launches_by_path"]["vocode"], wk_rows = analysis_smoke(dev,
                                                                       card)
    lap("15")
    (kernels[0]["launches_by_path"]["recipe"],
     kernels[0]["launches_by_path"]["serve_ns"],
     kernels[0]["launches_by_path"]["h5_fixture"],
     wk_fe) = recipe_smoke(dev, card)
    lap("16")
    kernels[0]["launches_by_path"]["run_synth"], wk_rs = synth_recipe_smoke(
        dev, card)
    lap("17")
    for name, row in wk_rows.items():
        row["launches_by_path"].update(feature_extract=wk_fe[name],
                                       run_synth=wk_rs[name])
    dp = dp_smoke(dev, card, case4, kernels[2]["train_step_ms"]["pallas"])
    lap("18")
    kernels[0]["launches_by_path"]["dp_decode"] = dp["k1"]
    kernels[1]["launches_by_path"] = {"serve": kernels[1]["launches"],
                                      "dp_decode": dp["w8a8"]}
    deep = deep_train_smoke(dev, card)
    lap("19")
    for row, n, d in zip(kernels[2:], dp["k2"], deep):
        row["launches_by_path"] = {"train": row["launches"], "dp_train": n,
                                   "deep_train": d.pop("launches")}
        row["deep_net"] = d
    mp_smoke(dev, card, kernels[2]["train_step_ms"]["xla"])
    lap("20-22")
    phase("time", "this script's wall by phase, s (host clock; 'build' from "
                  "this module's import on): " + ", ".join(
                      f"{b[0]} {b[1] - a[1]:.1f}"
                      for a, b in zip(laps, laps[1:]))
                  + f" (of 6-8, 7's orbax leg {extra['orbax_wall_s']:.1f})"
                  + f"; in all {laps[-1][1] - T_START:.1f} (limit "
                  f"{TIME_LIMIT_S})")
    kernels += list(wk_rows.values())
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def smoke(cfg, dev, card, seconds=(0.5, 1.0)):
    """Phases 3-5 on `dev`; returns the kernels' records."""
    import torch
    from scipy.io import wavfile

    from qpnet_tpu_torch import bench
    from qpnet_tpu_torch.models import generate as G
    from qpnet_tpu_torch.models.qpnet import init_params
    from qpnet_tpu_torch.ops import decode_mu_law
    from qpnet_tpu_torch.ops import gen_kernel as K
    up = cfg.upsampling_factor
    params = init_params(0, cfg, device=dev)

    # 3. K1 against its plain twin at full width, B=8, 4 frames
    rng = np.random.default_rng(1)
    B3, F3 = 8, 4
    x, h, _, d = make_inputs(rng, cfg, [F3] * B3)
    maxd, x_seed, d_gen = G._seed_and_d(cfg, x, d, F3 * up)
    h_pad, d_fr, _ = G._pallas_host_prep(cfg, h, d_gen, F3 * up, dev)
    h_pad, d_fr = h_pad[:F3], d_fr[:F3]   # exactly 4 frames
    packed, bufF0, bufA0, x0 = G._prologue(
        params, cfg, torch.as_tensor(x_seed, device=dev), h_pad[0], maxd,
        const_seed=True)
    phase("k1", f"B={B3} maxd bucket {maxd} d in [{d_gen.min():.3f}, "
                f"{d_gen.max():.3f}] rings F{tuple(bufF0.shape)} "
                f"A{tuple(bufA0.shape)}")
    n3 = F3 * up
    xf = torch.as_tensor(rng.integers(0, cfg.n_quantize, (n3, 1, B3)),
                         dtype=torch.int32, device=dev)
    common = (packed, cfg, bufF0, bufA0, x0, h_pad, d_fr, 7)
    kw = dict(B=B3, maxd=maxd, n_steps=n3)
    max_err, _, _ = forced_check(K, common, kw, xf, "k1")
    sample_check(K, common, kw, "k1")
    one = K.generate(*common, **kw, mode="sampling")
    again = K.generate(*common, **kw, mode="sampling")
    check(all(torch.equal(a, b) for a, b in zip(one, again)),
          "sampling twice must be bit-identical")
    half = dict(B=B3, maxd=maxd, n_steps=n3 // 2)
    c1 = K.generate(packed, cfg, bufF0, bufA0, x0, h_pad[:2], d_fr[:2], 7,
                    **half, mode="sampling")
    c2 = K.generate(packed, cfg, c1[1], c1[2], c1[3], h_pad[2:], d_fr[2:],
                    7, **half, mode="sampling", step_offset=n3 // 2)
    chunked = torch.cat([c1[0], c2[0]])
    check(torch.equal(chunked, one[0]) and torch.equal(c2[1], one[1])
          and torch.equal(c2[2], one[2]) and torch.equal(c2[3], one[3]),
          "2+2-frame chunks must equal one 4-frame call")
    phase("k1", "sampling deterministic; 2+2-frame chunks bit-identical "
                "to one 4-frame call (samples, bufF, bufA, x)")

    # 4. the main path: batch_fast_generate, B=20, 0.5-1.0 s utterances
    rng = np.random.default_rng(100)
    B = 20
    frames = sorted(int(f) for f in rng.integers(
        int(seconds[0] * FS) // up + 1, int(seconds[1] * FS) // up + 1,
        size=B))
    x, h, n_samples, d = make_inputs(rng, cfg, frames)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = G.batch_fast_generate(params, cfg, x, h, n_samples, d, seed=100,
                                mode="sampling", device=dev)
    wall = time.perf_counter() - t0
    launches = K.launch_count
    mem4 = peak_mib(dev)
    check(launches > 0, "the main path must launch K1")
    case4 = dict(x=x, h=h, n_samples=n_samples, d=d, out=out, wall=wall)
    with tempfile.TemporaryDirectory() as tmp:
        for i, s in enumerate(out):
            wav = np.clip(decode_mu_law(s, cfg.n_quantize) * 32768,
                          -32768, 32767).astype(np.int16)
            path = os.path.join(tmp, f"utt{i}.wav")
            wavfile.write(path, FS, wav)
            _, back = wavfile.read(path)
            check(len(back) == frames[i] * up - 1,
                  f"utt{i} length {len(back)} != {frames[i] * up - 1}")
            check(back.dtype == np.int16 and int(back.max()) > int(back.min()),
                  f"utt{i} must be non-constant int16")
    total = int(sum(n_samples))
    n_pad_steps = -(-max(n_samples) // (10 * up)) * 10 * up
    phase("main", f"batch_fast_generate B={B} frames {frames[0]}-"
                  f"{frames[-1]} maxd {G.bucket_maxd(float(d.max()))}: "
                  f"{wall:.3f} s wall, {total} samples, "
                  f"{total / wall:.1f} samples/s ({B * n_pad_steps} padded "
                  f"steps x rows, {n_pad_steps} steps), K1 launches "
                  f"{launches}, peak device memory {mem4:.1f} MiB | {card}")

    # 5. one K1 call at the main path's batch and maxd bucket, 4 frames:
    # held against the twins in forced mode, then timed and profiled
    args, maxd = bench.kernel_inputs(params, cfg, B, F3, seed=5)
    kw = dict(B=B, maxd=maxd, n_steps=n3)
    xf = torch.as_tensor(rng.integers(0, cfg.n_quantize, (n3, 1, B)),
                         dtype=torch.int32, device=dev)
    max_err, plain_ms, _ = forced_check(K, args, kw, xf, "k1")
    kw["mode"] = "sampling"
    ms, _ = bench.cuda_ms(lambda: K.generate(*args, **kw), reps=3)
    bound_ms, bound_by, mb, gflop, w_us = bench.k1_bound(args, B, n3)
    phase("time", f"K1 B={B} {n3} steps sampling: {ms:.3f} ms/call, "
                  f"{ms / n3 * 1e3:.2f} us/step; {launch_line(K, cfg, n3)}; "
                  f"plain twin (forced) {plain_ms:.3f} ms; bound "
                  f"{bound_ms:.4f} ms by {bound_by} ({mb:.2f} MB once, "
                  f"{gflop:.1f} GFLOP); weights re-read per step from HBM "
                  f"would take {w_us:.2f} us/step | {card}")
    phase("prof", prof_line(bench.kernel_us_per_step(args, kw, n3)) +
          f" | {card}")
    return [{
        "name": "gen_kernel", "route": "cuda",
        "source": "qpnet_tpu_torch/csrc/gen_kernel.cu",
        "replaces": "qpnet_tpu/ops/gen_kernel.py:649",
        "tpu_kernel": "qpnet_tpu/ops/gen_kernel.py::pallas_generate",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "ms_per_step": ms / n3, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}], case4


W8A8_RMSE_MAX, W8A8_AGREE_MIN = 0.10, 0.90     # w8a8 against bf16 logits
DEEP = "Rd10Rr3Ed4Er1"


def deep_smoke(cfg, params, dev, card, B=7, F=2, maxd=48):
    """Phase 9: K1-w8a8 and K1-bf16 against their twins at the deep
    network's full width; returns {quantize: (max |dlogit|, the sampling
    twin's ms, args, kw, the twin's steps)} for the records of phase 11."""
    import torch

    from qpnet_tpu_torch import bench
    from qpnet_tpu_torch.models import generate as G
    from qpnet_tpu_torch.ops import gen_kernel as K
    up, Q = cfg.upsampling_factor, cfg.n_quantize
    rng = np.random.default_rng(9)
    x, h, _, d = make_inputs(rng, cfg, [F] * B)
    n = F * up
    x_seed = np.full((B, cfg.receptive_field(maxd) + 1), Q // 2, np.int32)
    h_pad, d_fr, _ = G._pallas_host_prep(cfg, h, d[:, :n], n, dev)
    xf = torch.as_tensor(rng.integers(0, Q, (n, 1, B)), dtype=torch.int32,
                         device=dev)
    logits, out = {}, {}
    for q in ("w8a8", "none"):
        packed, bufF0, bufA0, x0 = G._prologue(
            params, cfg, torch.as_tensor(x_seed, device=dev), h_pad[0], maxd,
            const_seed=True, quantize=q)
        args = (packed, cfg, bufF0, bufA0, x0, h_pad[:F], d_fr[:F], 7)
        kw = dict(B=B, maxd=maxd, n_steps=n, quantize=q)
        name = "K1-w8a8" if q == "w8a8" else "K1-bf16"
        if q == "w8a8":
            phase("k1deep", f"{DEEP}: {len(cfg.dilationsF)} fixed + "
                            f"{len(cfg.dilationsA)} adaptive layers, B={B} "
                            f"maxd {maxd}, d in [{d[:, :n].min():.3f}, "
                            f"{d[:, :n].max():.3f}], rings "
                            f"F{tuple(bufF0.shape)} A{tuple(bufA0.shape)}")
        err, _, k_logits = forced_check(K, args, kw, xf, f"k1deep {name}")
        logits[q] = k_logits.float()
        k_s = K.generate(*args, **kw, mode="sampling")
        # the twin takes seconds: one call, on the host clock.  w8a8 must
        # equal it over the whole call; bf16 is held on its first sample
        # and first 40, so its twin runs the first frame only (a sample
        # depends on the seed and its step, not on the call's length)
        n_twin = n if q == "w8a8" else up
        twin_args = args[:5] + (args[5][:n_twin // up],
                                args[6][:n_twin // up], args[7])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r_s = K.generate_reference(*twin_args, **dict(kw, n_steps=n_twin),
                                   mode="sampling")
        torch.cuda.synchronize()
        twin_ms = (time.perf_counter() - t0) * 1e3
        ks, rs = (o[0][:, 0].T.cpu().numpy() for o in (k_s, r_s))
        agree = float((ks[:, :40] == rs[:, :40]).mean())
        if q == "w8a8":
            same = all(torch.equal(a, b) for a, b in zip(k_s, r_s))
            held = f"samples, rings and x equal to the twin {same}"
            check(same, f"{name} sampling must equal its twin bit for bit")
        else:
            held = (f"the twin over the first {n_twin}: samples equal "
                    f"{float((ks[:, :n_twin] == rs).mean()):.3f}")
        phase("k1deep", f"{name} sampling {n} steps: {held}; first sample "
                        f"equal {bool((ks[:, 0] == rs[:, 0]).all())}, "
                        f"40-sample agreement {agree:.3f} (twin "
                        f"{twin_ms:.1f} ms for {n_twin} steps)")
        check(bool((ks[:, 0] == rs[:, 0]).all()) and agree >= AGREE_MIN,
              f"{name} sampling: first sample and agreement {agree}")
        out[q] = (err, twin_ms, args, dict(kw, mode="sampling"), n_twin)
        del k_s, r_s
    ref, qz = logits["none"], logits["w8a8"]
    rel = float((qz - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())
    agree = float((qz.argmax(-1) == ref.argmax(-1)).float().mean())
    phase("k1deep", f"w8a8 against bf16 forced logits on the card: relative "
                    f"RMSE {rel:.4f} (max {W8A8_RMSE_MAX}), argmax agreement "
                    f"{agree:.4f} (min {W8A8_AGREE_MIN})")
    check(rel < W8A8_RMSE_MAX, f"w8a8 relative RMSE {rel}")
    check(agree > W8A8_AGREE_MIN, f"w8a8 argmax agreement {agree}")
    # the serving sessions' own batch (7 streams padded to 8), 2 frames
    args8, maxd8 = bench.kernel_inputs(params, cfg, 8, 2, seed=10,
                                       quantize="w8a8")
    kw8 = dict(B=8, maxd=maxd8, n_steps=2 * up, mode="sampling",
               quantize="w8a8")
    same = all(torch.equal(a, b) for a, b in zip(
        K.generate(*args8, **kw8), K.generate_reference(*args8, **kw8)))
    phase("k1deep", f"K1-w8a8 at the sessions' B=8, maxd {maxd8}, "
                    f"{2 * up} steps: equal to the twin {same}")
    check(same, "K1-w8a8 at B=8 must equal its twin")
    return out


def deep_main(dev, card):
    """Phases 9-11 on the deep network; returns K1-w8a8's record."""
    import torch

    from qpnet_tpu_torch.config import ModelConfig
    from qpnet_tpu_torch.models.qpnet import count_params, init_params
    cfg = ModelConfig.from_network_name(DEEP)
    params = init_params(0, cfg, device=dev)
    phase("k1deep", f"{DEEP}: {count_params(params):,} parameters, random "
                    f"from seed 0")
    deep = deep_smoke(cfg, params, dev, card)
    launches = serve_smoke(cfg, params, dev, card)
    call_ms = deep_times(cfg, params, card, deep)
    err, twin_ms, _, kw, _ = deep["w8a8"]
    ms, bound_ms, bound_by = call_ms["w8a8"]
    del deep, params
    torch.cuda.empty_cache()
    return {
        "name": "gen_kernel_w8a8", "route": "cuda",
        "source": "qpnet_tpu_torch/csrc/gen_kernel.cu",
        "replaces": "qpnet_tpu/ops/gen_kernel.py:304",
        "tpu_kernel": "qpnet_tpu/ops/gen_kernel.py::pallas_generate "
                      "(quantize='w8a8', mmq)",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "ms_per_step": ms / kw["n_steps"], "plain_ms": twin_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "network": DEEP, "B": kw["B"], "bf16_ms": call_ms["none"][0]}


def serve_smoke(cfg, params, dev, card, n_streams=7, maxd=48,
                seconds=(0.5, 1.0)):
    """Phase 10, the serving main path: `StreamingService` on the deep net
    at w8a8 behind `serve_tcp`, `n_streams` concurrent `request_stream`
    clients; returns the K1-w8a8 launches of the service runs."""
    import threading

    import torch

    from qpnet_tpu_torch import serve as S
    from qpnet_tpu_torch.bench import f0_track
    from qpnet_tpu_torch.models.generate import StreamingGenerator
    from qpnet_tpu_torch.ops import decode_mu_law, dilated_factor
    from qpnet_tpu_torch.ops import gen_kernel as K
    up = cfg.upsampling_factor
    rng = np.random.default_rng(10)
    frames = [int(f) for f in rng.integers(int(seconds[0] * FS) // up + 1,
                                           int(seconds[1] * FS) // up + 1,
                                           size=n_streams)]
    utts = [(rng.normal(size=(f, cfg.n_aux)).astype(np.float32),
             dilated_factor(f0_track(rng, f, unvoiced=0.1), FS,
                            cfg.dense_factor).astype(np.float32))
            for f in frames]
    kw = dict(max_streams=n_streams, maxd=maxd, min_chunk_samples=5500,
              first_chunk_samples=1100, quantize="w8a8", devices=[dev])

    def serve(mode, **gather):
        """(per-stream (pcm, seconds to first audio, wall seconds), service
        stats, K1-w8a8 launches) of one burst of TCP clients."""
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_count()
        svc = S.StreamingService(params, cfg, mode=mode, **gather, **kw)
        svc.prewarm([n_streams])
        srv = S.serve_tcp(svc, port=0)
        results = [None] * n_streams
        errors = []

        def client(i):
            try:
                t0 = time.perf_counter()
                first, chunks = None, []
                for c in S.request_stream(srv.server_address, *utts[i]):
                    if first is None:
                        first = time.perf_counter() - t0
                    chunks.append(c)
                results[i] = (np.concatenate(chunks), first,
                              time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"stream {i}: {e!r}")

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_streams)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        finally:
            srv.shutdown()
            srv.server_close()
            svc.close()
        check(not errors and all(not t.is_alive() for t in threads),
              f"{mode} streams: {errors}")
        return results, dict(svc.stats), K.w8a8_launch_count

    # argmax, gathered into one group: each stream equals one direct session
    # fed the group's padded conditioning (rows are independent in argmax)
    res, stats, launches = serve("argmax", gather_window_s=60.0,
                                 gather_quiet_s=30.0)
    check(stats["groups"] == 1, f"the {n_streams} streams must form one "
                                f"group, got {stats}")
    F_max = max(frames)
    B = 1 << (n_streams - 1).bit_length()
    h = np.zeros((B, F_max, cfg.n_aux), np.float32)
    d = np.ones((B, F_max), np.float32)
    for i, (hi, di) in enumerate(utts):
        h[i], d[i] = hi[-1], di[-1]
        h[i, :len(hi)], d[i, :len(di)] = hi, di
    direct = StreamingGenerator(params, cfg, B, maxd=maxd, mode="argmax",
                                quantize="w8a8", device=dev).feed(h, d)
    equal = []
    for i, (f, (got, _, _)) in enumerate(zip(frames, res)):
        want = np.clip(decode_mu_law(direct[i, :f * up], cfg.n_quantize)
                       * 32768, -32768, 32767).astype(np.int16)
        equal.append(got.dtype == np.int16 and np.array_equal(got, want))
    phase("serve", f"{DEEP} w8a8 argmax, {n_streams} TCP streams of "
                   f"{min(frames)}-{max(frames)} frames in one group "
                   f"(session B={B}, maxd {maxd}, {stats['feeds']} feeds): "
                   f"PCM equal to one direct StreamingGenerator: "
                   f"{sum(equal)}/{n_streams}, K1-w8a8 launches {launches}")
    check(all(equal), "served argmax PCM must equal the direct generator's")
    check(launches > 0, "the serving path must launch K1-w8a8")
    total = launches

    # sampling: what a client sees
    res, stats, launches = serve("sampling", gather_window_s=0.25)
    total += launches
    check(launches > 0, "the serving path must launch K1-w8a8")
    ttfa = [r[1] for r in res]
    rtf = [f * up / FS / r[2] for f, r in zip(frames, res)]
    for f, (pcm, _, _) in zip(frames, res):
        check(pcm.shape == (f * up,) and int(pcm.max()) > int(pcm.min()),
              "sampled streams must be non-constant PCM of their length")
    phase("serve", f"{DEEP} w8a8 sampling, {n_streams} TCP streams, "
                   f"{stats['groups']} group(s), {stats['feeds']} feeds: "
                   f"time to first audio s "
                   f"{[round(t, 4) for t in ttfa]} (median "
                   f"{float(np.median(ttfa)):.4f}), realtime factor per "
                   f"stream {[round(r, 4) for r in rtf]} (median "
                   f"{float(np.median(rtf)):.4f}), K1-w8a8 launches "
                   f"{launches}, peak device memory {peak_mib(dev):.1f} MiB"
                   f" | {card}")
    torch.cuda.empty_cache()
    return total


def deep_times(cfg, params, card, deep):
    """Phase 11: K1 ms/step on the deep net, bf16 and w8a8, at B=7 and
    B=64, beside the bound, the twin (B=7, from phase 9) and the device
    time by CUDA kernel; returns {quantize: ms per phase 9 call}."""
    from qpnet_tpu_torch import bench
    from qpnet_tpu_torch.ops import gen_kernel as K
    up = cfg.upsampling_factor
    call_ms = {}
    for q in ("none", "w8a8"):
        for B in (deep[q][3]["B"], 64):
            if B != 64:
                args, kw = deep[q][2], deep[q][3]
            else:
                args, maxd = bench.kernel_inputs(params, cfg, B, 4, seed=11,
                                                 quantize=q)
                kw = dict(B=B, maxd=maxd, n_steps=4 * up, mode="sampling",
                          quantize=q)
            n = kw["n_steps"]
            ms, _ = bench.cuda_ms(lambda: K.generate(*args, **kw))
            bound_ms, bound_by, mb, gflop, w_us = bench.k1_bound(args, B, n, q)
            twin = (f"plain twin {deep[q][1] / deep[q][4]:.3f} ms/step"
                    if B != 64 else "plain twin not timed at this batch")
            phase("time", f"K1-{'w8a8' if q == 'w8a8' else 'bf16'} {DEEP} "
                          f"B={B} maxd {kw['maxd']} {n} steps: "
                          f"{ms / n * 1e3:.2f} us/step ({ms:.3f} ms/call); "
                          f"{twin}; bound {bound_ms / n * 1e3:.4f} us/step by "
                          f"{bound_by} ({mb:.2f} MB once, {gflop:.1f} GFLOP "
                          f"per call); weights once per step {w_us:.2f} us; "
                          f"{launch_line(K, cfg, n)}; "
                          f"{prof_line(bench.kernel_us_per_step(args, kw, n))}"
                          f" | {card}")
            if B != 64:
                call_ms[q] = (ms, bound_ms, bound_by)
            del args
    return call_ms


# K2, max |d| / max |ref|: f32 against the f32 twin; bf16 against the twin
# summed in float64, within max(K2_BF16_TOL, 2 x the f32-summing twin's)
K2_TOL, K2_BF16_TOL = 1e-4, 2e-2
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-4, 1e-3       # engine against engine


K2_OUTPUTS = ("o_out", "skip", "oall", "st", "do0", "dh", "dW_in", "dW_aux",
              "db_gate", "dW_out", "db_res")


def k2_outputs(fwd, bwd):
    """The K2 outputs in K2_OUTPUTS order from a forward's (o_out, skip,
    oall, st) and a backward's (do0, dh, weight gradients)."""
    return list(fwd) + [bwd[0], bwd[1]] + [
        bwd[2][k] for k in ("W_in", "W_aux", "b_gate", "W_out", "b_res")]


def tree_names(tree, prefix=""):
    """The tree with each leaf replaced by its path, e.g. /fixed/0/W_skip."""
    if isinstance(tree, dict):
        return {k: tree_names(v, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_names(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
    return prefix


def rel_err(a, b):
    """(max |a - b| / max |b|, max |a - b|)."""
    d = float((a.float() - b.float()).abs().max())
    return d / max(float(b.float().abs().max()), 1e-30), d


def memory_corpus(cfg, seed, n_utts=3, seconds=(2.0, 3.0)):
    """In-memory utterances (fs, x, h) at 22,050 Hz: a pitched tone whose
    F0 (continuous, 80-300 Hz) is the aux's F0 column, random spectral
    dims, and the scaler of their frames (uv dim pinned to 0/1)."""
    from qpnet_tpu_torch.bench import f0_track
    from qpnet_tpu_torch.data.stats import Scaler
    rng = np.random.default_rng(seed)
    up = cfg.upsampling_factor
    utts = []
    for _ in range(n_utts):
        F = int(rng.uniform(*seconds) * FS) // up
        f0 = f0_track(rng, F)
        phase_ = np.cumsum(2 * np.pi * np.repeat(f0, up) / FS)
        x = 0.4 * np.sin(phase_) + 0.02 * rng.normal(size=F * up)
        h = rng.normal(size=(F, cfg.n_aux))
        h[:, 0], h[:, 1] = 1.0, f0
        utts.append((FS, x.astype(np.float32), h))
    frames = np.concatenate([u[2] for u in utts])
    mean, scale = frames.mean(0), frames.std(0)
    mean[0], scale[0] = 0.0, 1.0
    return utts, Scaler.from_stats(mean, scale)


def k2_check(params, cfg, batch, dtype, fused, dev, label="k2"):
    """K2's forward and backward against their twins on the call that
    `forward(fixed_engine="pallas")` makes on `batch` (fixed layers only,
    or with the adaptive layers fused at the batch's maxd bucket): f32
    within K2_TOL of the f32 twin; bf16 on the f64-summing twin's gate;
    the fixed-only backward bit-identical when repeated.  Returns ((max
    |d| of the forward's outputs, of the backward's), (twin forward ms,
    twin backward ms))."""
    import torch

    from qpnet_tpu_torch import bench
    from qpnet_tpu_torch.ops import train_kernel as TK
    f32 = torch.float32
    dname = "float32" if dtype == f32 else "bfloat16"
    static, W, o0, h, d = bench.stack_inputs(params, cfg, batch, dtype, fused)
    tag = f"{dname} {'fused' if fused else 'fixed'}"
    k_out = TK.stack_forward(static, dtype, W, o0, h, d)
    gen = torch.Generator(device=dev).manual_seed(7)
    do = torch.randn(k_out[0].shape, generator=gen, device=dev)
    dsk = torch.randn(k_out[1].shape, generator=gen, device=dev)
    k_b = TK.stack_backward(static, dtype, W, k_out[2], k_out[3], h, d, do,
                            dsk)
    # the twins: one call each, on the host clock
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r_out = TK.fixed_stack_reference_fwd(static, dtype, W, o0, h, d)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    r_b = TK.fixed_stack_reference_bwd(static, dtype, W, k_out[2], k_out[3],
                                       h, d, do, dsk)
    torch.cuda.synchronize()
    twin_ms = ((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3)
    names = list(K2_OUTPUTS)
    kern, twin = k2_outputs(k_out, k_b), k2_outputs(r_out, r_b)
    del r_out, r_b
    for n, a in zip(names, kern):
        check(bool(torch.isfinite(a).all()), f"K2 {tag} {n} finite")
    if dtype == f32:
        # f32: each output within K2_TOL of the f32 twin
        res = {n: rel_err(a, b) for n, a, b in zip(names, kern, twin)}
        tol = {n: K2_TOL for n in names}
        against = "the f32 twin"
    else:
        # bf16: the kernel and the f32-summing twin each against the twin
        # summed in float64, the kernel within max(K2_BF16_TOL, 2 x the
        # f32-summing twin's distance) for each output
        r64 = k2_outputs(TK.fixed_stack_reference_fwd(
            static, dtype, W, o0, h, d, f64_sums=True),
            TK.fixed_stack_reference_bwd(
                static, dtype, W, k_out[2], k_out[3], h, d, do, dsk,
                f64_sums=True))
        res = {n: rel_err(a, b) for n, a, b in zip(names, kern, r64)}
        t32 = {n: rel_err(a, b)[0] for n, a, b in zip(names, twin, r64)}
        tol = {n: max(K2_BF16_TOL, 2 * t32[n]) for n in names}
        against = "the f64 twin"
        del r64
    worst = max(names, key=lambda n: res[n][0] / tol[n])
    phase(label, f"{tag} {len(static[0]) + len(static[1])} layers, B="
                 f"{o0.shape[0]} T={o0.shape[1]}, maxd {static[2]}, against "
                 f"{against}: worst {worst} {res[worst][0]:.3e} (tol "
                 f"{tol[worst]:.3e}); "
                 + ", ".join(f"{n} {res[n][0]:.1e}" for n in names)
                 + ("" if dtype == f32 else "; f32-summing twin: " +
                    ", ".join(f"{n} {t32[n]:.1e}" for n in names)))
    for n in names:
        check(res[n][0] <= tol[n], f"K2 {tag} {n} {res[n][0]} > {tol[n]}")
    if not fused:
        again = TK.stack_backward(static, dtype, W, k_out[2], k_out[3], h, d,
                                  do, dsk)
        same = all(torch.equal(a, b) for a, b in
                   zip(k_b[:2] + tuple(k_b[2].values()),
                       again[:2] + tuple(again[2].values())))
        phase(label, f"{tag} backward twice bit-identical: {same}")
        check(same, f"K2 {tag} backward must be deterministic")
    fwd_err = max(res[n][1] for n in names[:4])
    bwd_err = max(res[n][1] for n in names[4:])
    return (fwd_err, bwd_err), twin_ms


def orbax_smoke(cfg, dev, card, expdir, state, steps, extra):
    """Phase 7's orbax leg in `expdir`, where train_loop left its pickles,
    and the committed JAX fixture; its wall and K1 launches go into
    `extra`."""
    import torch

    from qpnet_tpu_torch.api import Vocoder
    from qpnet_tpu_torch.config import RunConfig
    from qpnet_tpu_torch.ops import gen_kernel as K
    from qpnet_tpu_torch.train import checkpoint as TC
    from qpnet_tpu_torch.train import orbax_format as OF
    from qpnet_tpu_torch.train import step as TS
    from qpnet_tpu_torch.train import zstd as Z
    from qpnet_tpu_torch.train import zstd_native as N
    t_start = time.perf_counter()

    def same(a, b):
        la, lb = TS.tree_leaves(a), TS.tree_leaves(b)
        return len(la) == len(lb) and all(
            x.dtype == y.dtype and np.array_equal(x, y)
            for x, y in zip(la, lb))

    opt = TS.optimizer_state(state.opt_state, state.params)
    t0 = time.perf_counter()
    paths = (TC.save_checkpoint(expdir, state.params, opt, steps,
                                backend="orbax"),
             TC.save_final(expdir, state.params, backend="orbax"))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = [TC.load_checkpoint(p) for p in paths]
    load_s = time.perf_counter() - t0
    ref = [TC.load_checkpoint(os.path.join(expdir, n)) for n in
           (f"checkpoint-{steps}.pkl", "checkpoint-final.pkl")]
    adam = TC.adam_state_from_optax(got[0]["optimizer"])
    check(got[0]["iterations"] == steps and adam["count"] == steps,
          f"orbax iteration {got[0]['iterations']}, count {adam['count']}")
    check(same(got[0]["model"], ref[0]["model"])
          and same(got[1]["model"], ref[1]["model"])
          and same(adam["mu"], ref[0]["optimizer"]["mu"])
          and same(adam["nu"], ref[0]["optimizer"]["nu"]),
          "orbax checkpoints must reload equal to the pickles")
    mb = sum(a.nbytes for t in (got[0]["model"], adam["mu"], adam["nu"])
             for a in TS.tree_leaves(t)) / 1e6
    # K1 from the .orbax final, beside the same decode from the pickle
    RunConfig(model=cfg).save(os.path.join(expdir, "model.conf"))
    feats = np.random.default_rng(8).standard_normal(
        (2, cfg.n_aux)).astype(np.float32)
    feats[:, 0], feats[:, 1] = 1.0, 120.0
    wavs, launches = [], []
    for ck in (paths[1], os.path.join(expdir, "checkpoint-final.pkl")):
        voc = Vocoder.load(expdir, checkpoint=ck, device=dev, mode="argmax")
        K.reset_launch_count()
        wavs.append(voc.synthesize(feats))
        launches.append(K.launch_count)
    check(min(launches) > 0, f"the decodes must launch K1: {launches}")
    launches = extra["orbax_k1_launches"] = launches[0]
    n_want = 2 * cfg.upsampling_factor - 1
    check(wavs[0].shape == (n_want,) and np.array_equal(wavs[0], wavs[1]),
          "K1's decode from the .orbax checkpoint must equal the pickle's")
    del voc
    torch.cuda.empty_cache()
    phase("orbax", f"train_loop's state through the orbax backend: "
                   f"{mb:.1f} MB of f32 (parameters, Adam's mu and nu) "
                   f"saved as checkpoint-{steps}.orbax and "
                   f"checkpoint-final.orbax in {save_s:.3f} s, loaded in "
                   f"{load_s:.3f} s, every leaf equal to the pickles, count "
                   f"{adam['count']}; Vocoder.load of the .orbax final, K1 "
                   f"argmax B=1 2 frames: {n_want} samples equal to the "
                   f"pickle's, K1 launches {launches} | {card}")

    # the JAX package's own orbax checkpoint, committed beside the tests
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "data", "orbax_fixture")
    frames = []

    def native(data):
        frames.append(bytes(data))
        return N.decompress(data)

    def native_into(data, out):
        frames.append(bytes(data))
        return N.decompress_into(data, out)

    orb = OF.read_checkpoint(os.path.join(fixture, "checkpoint-2.orbax"),
                             native, native_into)
    pkl = TC.load_checkpoint(os.path.join(fixture, "checkpoint-2.pkl"))
    a, b = (TC.adam_state_from_optax(t["optimizer"]) for t in (orb, pkl))
    check(orb["iterations"] == 2 and a["count"] == b["count"] == 2
          and same(orb["model"], pkl["model"]) and same(a["mu"], b["mu"])
          and same(a["nu"], b["nu"]),
          "the JAX orbax fixture must load equal to its pickle twin")
    t0 = time.perf_counter()
    plain = [Z.decompress(f) for f in frames]
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(10):
        mine = [N.decompress(f) for f in frames]
    native_s = (time.perf_counter() - t0) / 10
    check(mine == plain, "the C++ zstd decoder must equal the plain one on "
                         "every frame of the fixture")
    out_mb = sum(map(len, plain)) / 1e6
    wall = time.perf_counter() - t_start
    extra["orbax_wall_s"] = wall
    phase("orbax", f"JAX fixture (OCDBT, zstd level 1): equal to its "
                   f"pickle twin; {len(frames)} zstd frames "
                   f"({sum(map(len, frames)) / 1e6:.3f} MB in, "
                   f"{out_mb:.3f} MB out), C++ decoder equal to the plain "
                   f"one on all, {out_mb / native_s:.1f} MB/s (plain "
                   f"Python {out_mb / plain_s:.2f} MB/s; host clock, "
                   f"mean of 10); this leg's wall {wall:.2f} s | {card}")


def train_smoke(cfg, dev, card, T=30030, steps=4, max_length=30000,
                batch_length=20000, extra=None):
    """Phases 6-8 on `dev`; returns the K2 kernels' records.  extra: a
    dict that takes the orbax leg's wall and K1 launches."""
    import torch

    from qpnet_tpu_torch import bench
    from qpnet_tpu_torch.config import TrainConfig
    from qpnet_tpu_torch.data import batcher as DB
    from qpnet_tpu_torch.models.qpnet import init_params, tree_map
    from qpnet_tpu_torch.ops import train_kernel as TK
    from qpnet_tpu_torch.train import step as TS
    from qpnet_tpu_torch.train import trainer as TT
    from qpnet_tpu_torch.train.checkpoint import load_checkpoint
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
    params = init_params(0, cfg, device=dev)

    # 6. K2 against its twins at full width
    batch = bench.train_batch(cfg, 1, T, seed=6, valid_len=batch_length)
    errs, twin_ms = {}, {}
    for dtype in (f32, bf16):
        dname = "float32" if dtype == f32 else "bfloat16"
        for fused in (False, True):
            errs[(dname, fused)], twin_ms[(dname, fused)] = k2_check(
                params, cfg, batch, dtype, fused, dev)
    torch.cuda.empty_cache()

    # 7. the training main path: train_loop through the kernels
    utts, scaler = memory_corpus(cfg, seed=7)
    tcfg = TrainConfig(lr=1e-4, iters=steps, checkpoint_interval=steps,
                       intervals=1, batch_length=batch_length,
                       max_length=max_length, batch_size=1, seed=1,
                       fixed_engine="pallas")

    def batches():
        return DB.window_batches(
            DB.utterance_stream(utts, lambda u: u, seed=1), cfg,
            feat_transform=scaler.transform, batch_length=batch_length,
            batch_size=1, max_length=max_length)

    with tempfile.TemporaryDirectory() as expdir:
        torch.cuda.reset_peak_memory_stats()
        TK.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = TT.train_loop(cfg, tcfg, batches(), expdir, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (TK.fwd_launch_count, TK.bwd_launch_count)
        check(min(launches) > 0, f"the main path must launch both K2 "
                                 f"kernels, got {launches}")
        losses = TT.read_loss_record(os.path.join(expdir, "loss-final.yml"))
        check(len(losses) == steps and all(np.isfinite(losses)),
              f"losses {losses}")
        final = load_checkpoint(os.path.join(expdir, "checkpoint-final.pkl"))
        ckpt = load_checkpoint(os.path.join(expdir,
                                            f"checkpoint-{steps}.pkl"))
        mine = [p.detach().cpu().numpy() for p in
                TS.tree_leaves(state.params)]
        for tree in (final["model"], ckpt["model"]):
            check(all(np.array_equal(a, b) for a, b in
                      zip(TS.tree_leaves(tree), mine)),
                  "checkpoints must reload equal to the trained params")
        check(ckpt["iterations"] == steps
              and ckpt["optimizer"]["count"] == steps, "checkpoint state")
        orbax_smoke(cfg, dev, card, expdir, state, steps,
                    {} if extra is None else extra)
        b_np = next(batches())
    phase("main", f"train_loop, kernel engine, f32, B=1, T={T}, "
                  f"{steps} steps: losses {[round(x, 6) for x in losses]}, "
                  f"{wall:.3f} s wall (build and checkpoints included), K2 "
                  f"launches fwd {launches[0]} bwd {launches[1]}; "
                  f"checkpoint-final.pkl and checkpoint-{steps}.pkl reload "
                  f"equal; peak device memory {peak_mib(dev):.1f} MiB | "
                  f"{card}")
    b_np.pop("window_lens")
    b = TS.batch_to_device(b_np, dev)
    # one step's loss and gradients with each engine, and with the plain
    # engine in f64: the weight gradients are cancelling sums over all T
    # rows, whose f32 rounding alone moves either engine by 1e-3 to 5e-3
    # of a leaf's scale, so the f64 gradient is the yardstick
    losses, grads = {}, {}
    for engine, dtype in (("xla", f32), ("pallas", f32), ("f64", f64)):
        p = tree_map(lambda t: t.detach().to(dtype).requires_grad_(),
                     state.params)
        loss = TS._loss_fn(p, cfg, b, dtype, False,
                           "xla" if engine == "f64" else engine)
        loss.backward()
        losses[engine] = float(loss.detach())
        grads[engine] = [torch.zeros_like(x) if x.grad is None
                         else x.grad.double() for x in TS.tree_leaves(p)]
    loss_rel = abs(losses["pallas"] - losses["xla"]) / abs(losses["xla"])
    names = TS.tree_leaves(tree_names(state.params))
    rows = []
    for n, gp, gx, gt in zip(names, grads["pallas"], grads["xla"],
                             grads["f64"]):
        rows.append((rel_err(gp, gx)[0], rel_err(gp, gt)[0],
                     rel_err(gx, gt)[0], n))
    worst = max(rows)
    worst_x = max(r[2] for r in rows)
    bad = [r for r in rows if r[1] > max(STEP_GRAD_TOL, 2 * worst_x)]
    phase("main", f"one step from the trained params: loss xla "
                  f"{losses['xla']:.7f} pallas {losses['pallas']:.7f} f64 "
                  f"{losses['f64']:.7f} (engines rel {loss_rel:.2e}, tol "
                  f"{STEP_LOSS_TOL}); gradient leaves, max |d| / max |ref|: "
                  f"worst pallas-vs-xla {worst[3]} {worst[0]:.2e} (against "
                  f"f64: pallas {worst[1]:.2e}, xla {worst[2]:.2e}); worst "
                  f"pallas-vs-f64 {max(r[1] for r in rows):.2e}, worst "
                  f"xla-vs-f64 {worst_x:.2e}; leaves where pallas is "
                  f"farther from f64 than max({STEP_GRAD_TOL}, 2 x xla's "
                  f"worst): {len(bad)}")
    check(loss_rel <= STEP_LOSS_TOL, f"engine losses differ by {loss_rel}")
    check(not bad, f"kernel-engine gradients off the f64 gradient: {bad}")
    del grads, state
    torch.cuda.empty_cache()

    # 8. times at the main path's variant (fixed layers only), f32 and bf16
    times, steps_ms = {}, {}
    for dtype in (f32, bf16):
        dname = "float32" if dtype == f32 else "bfloat16"
        times[dname] = k2_times(params, cfg, batch, dtype,
                                twin_ms[(dname, False)], dev, card)
        steps_ms[dname] = {e: bench.train_step_ms(params, cfg, b_np, e,
                                                  dtype)[0]
                           for e in ("xla", "pallas")}
        phase("time", f"train step {dname} B=1 T={T}: xla "
                      f"{steps_ms[dname]['xla']:.3f} ms, pallas "
                      f"{steps_ms[dname]['pallas']:.3f} ms | {card}")
    common = {"route": "cuda", "source": "qpnet_tpu_torch/csrc/train_kernel.cu",
              "library_is": "products only, torch.matmul, f32 without TF32"}
    return [
        dict(name=f"train_kernel_{name}", **common,
             replaces=f"qpnet_tpu/ops/train_kernel.py:{line}",
             tpu_kernel=f"qpnet_tpu/ops/train_kernel.py::_{name}_call",
             launches=launches[i], max_abs_err=errs[("float32", False)][i],
             **times["float32"][name],
             bf16_ms=times["bfloat16"][name]["ms"],
             bf16_bound_ms=times["bfloat16"][name]["bound_ms"],
             bf16_library_ms=times["bfloat16"][name]["library_ms"],
             train_step_ms=steps_ms["float32"])
        for i, (name, line) in enumerate((("fwd", 195), ("bwd", 431)))]


def k2_times(params, cfg, batch, dtype, twin_ms, dev, card, net=""):
    """K2's forward and backward (fixed layers only) on `batch`, each
    timed with CUDA events beside its bound, its twin's time (`twin_ms`,
    from `k2_check`), the same products through torch.matmul and the
    device ms by CUDA kernel; prints one line per call and returns
    {"fwd": {ms, plain_ms, bound_ms, bound_by, library_ms}, "bwd": ...}."""
    import torch

    from qpnet_tpu_torch import bench
    from qpnet_tpu_torch.ops import train_kernel as TK
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    static, W, o0, h, d = bench.stack_inputs(params, cfg, batch, dtype, False)
    B, T = o0.shape[:2]
    f_ms, out = bench.cuda_ms(
        lambda: TK.stack_forward(static, dtype, W, o0, h, d))
    gen = torch.Generator(device=dev).manual_seed(8)
    do = torch.randn(out[0].shape, generator=gen, device=dev)
    dsk = torch.randn(out[1].shape, generator=gen, device=dev)
    b_ms, _ = bench.cuda_ms(lambda: TK.stack_backward(
        static, dtype, W, out[2], out[3], h, d, do, dsk))
    bounds = bench.stack_bounds(static, B, T, dtype)
    by_kernel = [bench.k2_kernels(bench.device_ms_by_kernel(fn)) for fn in (
        lambda: TK.stack_forward(static, dtype, W, o0, h, d),
        lambda: TK.stack_backward(static, dtype, W, out[2], out[3], h, d,
                                  do, dsk))]
    lib_ms = bench.stack_library_ms(static, B, T, dtype)
    res = {}
    for i, (name, ms) in enumerate((("fwd", f_ms), ("bwd", b_ms))):
        bd = bounds[name]
        per = ("not measured (the profiler saw none)"
               if by_kernel[i] is None else ", ".join(
                   f"{k} {v:.3f}" for k, v in by_kernel[i].items()))
        phase("time", f"K2-{name} {dname} {net}B={B} T={T} "
                      f"{len(static[0])} layers: {ms:.3f} ms "
                      f"({bd[2] / ms / 1e9:.2f} TFLOP/s); bound {bd[0]:.4f} "
                      f"ms by {bd[1]} ({bd[4]}); plain twin "
                      f"{twin_ms[i]:.3f} ms; torch.matmul products only "
                      f"{lib_ms[i]:.3f} ms; device ms by kernel: {per} | "
                      f"{card}")
        res[name] = dict(ms=ms, plain_ms=twin_ms[i], bound_ms=bd[0],
                         bound_by=bd[1], library_ms=lib_ms[i])
    del out
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 12-14: the scan engine, validation and conversion, the soak
# ---------------------------------------------------------------------------

SCAN_F32_TOL = 1e-4          # f32 scan against the f32 forward, of scale


def peak_mib(dev) -> float:
    """Peak device memory (MiB) since the last reset
    (`torch.cuda.max_memory_allocated`)."""
    import torch
    return torch.cuda.max_memory_allocated(dev.index or 0) / 2 ** 20


def median_ms(fn, calls=5):
    """(median, lowest, highest) ms of `calls` calls of fn after a warm-up
    call, each timed alone with CUDA events."""
    import torch
    fn()
    ms = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
    return float(np.median(ms)), min(ms), max(ms)


def varying_d(rng, cfg, B, F):
    """(B, F * up) sample-rate dilation factors interpolated between the
    frames of F0 tracks in 80-300 Hz with 10% unvoiced frames, so d varies
    within frames, as a continuous F0 does.  The first row starts at 80 Hz
    (d = 34.5), which puts the batch in the maxd bucket 48."""
    from qpnet_tpu_torch.bench import f0_track
    from qpnet_tpu_torch.ops import dilated_factor
    up = cfg.upsampling_factor
    f0 = np.stack([f0_track(rng, F, unvoiced=0.1) for _ in range(B)])
    f0[0, 0] = 80.0
    t = np.arange(F * up) / up
    return np.stack([np.interp(t, np.arange(F), dilated_factor(
        row, FS, cfg.dense_factor)) for row in f0]).astype(np.float32)


def replay_logits(params, cfg, xs, h, d):
    """The tests/test_generate.py replay: the f32 teacher-forced forward
    over [mid-scale history of rf, the seed, xs[:, :-1]], with the first
    frame's upsampled aux and d = 1 over the history.  Returns the (B, n,
    Q) logits step i of a generation with a mid-scale seed would give."""
    import torch

    from qpnet_tpu_torch.models.generate import bucket_maxd
    from qpnet_tpu_torch.models.qpnet import forward, upsample_aux
    B, n = xs.shape
    dev = params["up_w"].device
    rf = cfg.receptive_field(bucket_maxd(float(np.ceil(d.max()))))
    x_full = np.concatenate([np.full((B, rf + 1), cfg.n_quantize // 2),
                             xs[:, :-1]], 1)
    h_up = upsample_aux(params, torch.as_tensor(h, device=dev),
                        cfg.upsampling_factor)
    h_up = torch.cat([h_up[:, :1].expand(B, rf, -1), h_up[:, :n]], 1)
    d_full = np.concatenate([np.ones((B, rf)), d[:, :n]], 1)
    with torch.no_grad():
        return forward(params, cfg, torch.as_tensor(x_full, device=dev),
                       None, torch.as_tensor(d_full, dtype=torch.float32,
                                             device=dev),
                       h_up=h_up)[:, rf:rf + n].cpu().numpy()


SCAN_CALLS = 2       # timed calls per type and batch (5 until the run's
                     # time limit grew tight, 3 until phase 15's wide
                     # branches came; no gate reads them)


def scan_smoke(cfg, dev, card, B=8, F=4):
    """Phase 12: the scan engine on the card, default network at full
    width, B=8, 4 frames, d varying within frames (maxd bucket 48)."""
    import torch

    from qpnet_tpu_torch import bench
    from qpnet_tpu_torch.models import generate as G
    from qpnet_tpu_torch.models.qpnet import init_params
    from qpnet_tpu_torch.ops import gen_kernel as K
    f32, bf16 = torch.float32, torch.bfloat16
    up, Q = cfg.upsampling_factor, cfg.n_quantize
    torch.cuda.reset_peak_memory_stats()
    params = init_params(0, cfg, device=dev)
    rng = np.random.default_rng(12)
    n = F * up
    h = rng.normal(size=(B, F, cfg.n_aux)).astype(np.float32)
    d = varying_d(rng, cfg, B, F)
    x0 = np.full((B, 1), Q // 2, np.int32)
    maxd = G.bucket_maxd(float(np.ceil(d.max())))
    check(maxd == 48 and not G._frame_constant(d, up)
          and G._use_scan("auto", "none", d, up),
          f"phase 12's d must vary within frames in bucket 48 ({maxd})")

    # the route: auto takes the scan for this d, and K1 never launches;
    # sampling twice with one seed is bit-identical
    K.reset_launch_count()
    kw = dict(seed=100, mode="sampling", device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = G.batch_fast_generate(params, cfg, x0, h, [n - 1] * B, d, **kw)
    wall = time.perf_counter() - t0
    two = G.batch_fast_generate(params, cfg, x0, h, [n - 1] * B, d, **kw)
    same = all(np.array_equal(a, b) for a, b in zip(one, two))
    check(K.launch_count == 0, "auto must route this input to the scan")
    check(same, "scan sampling twice with one seed must be bit-identical")
    phase("scan", f"auto with d in [{d.min():.3f}, {d.max():.3f}] varying "
                  f"within frames ran the scan (K1 launches 0), B={B} "
                  f"{n - 1} steps bf16 sampling in {wall:.3f} s; twice "
                  f"with seed 100 bit-identical: {same}")

    # forced logits: f32 against the f32 forward, int8_weights against
    # bf16, bf16 against f32
    xf = rng.integers(0, Q, (B, n)).astype(np.int32)
    logits = {}
    for name, dt, q in (("f32", f32, "none"), ("bf16", bf16, "none"),
                        ("int8_weights", bf16, "int8_weights")):
        logits[name] = G.teacher_forced_logits(
            params, cfg, x0, h, xf, d, compute_dtype=dt, quantize=q,
            device=dev)
        check(np.isfinite(logits[name]).all(), f"scan {name} logits finite")
    ref = replay_logits(params, cfg, xf, h, d)
    f32_err = float(np.abs(logits["f32"] - ref).max() / np.abs(ref).max())
    q, b = logits["int8_weights"], logits["bf16"]
    q_rel = float(np.sqrt(np.mean((q - b) ** 2)) / np.sqrt(np.mean(b ** 2)))
    q_agree = float((q.argmax(-1) == b.argmax(-1)).mean())
    b_agree = float((b.argmax(-1) == logits["f32"].argmax(-1)).mean())
    phase("scan", f"forced {n} steps: f32 against the f32 forward max |d| / "
                  f"max |ref| {f32_err:.3e} (tol {SCAN_F32_TOL}); "
                  f"int8_weights against bf16 relative RMSE {q_rel:.4f} "
                  f"(max {W8A8_RMSE_MAX}), argmax agreement {q_agree:.4f} "
                  f"(min {W8A8_AGREE_MIN}); bf16 against f32 argmax "
                  f"agreement {b_agree:.4f} (min {ARGMAX_AGREE_MIN})")
    check(f32_err <= SCAN_F32_TOL, f"f32 scan off the forward: {f32_err}")
    check(q_rel < W8A8_RMSE_MAX and q_agree > W8A8_AGREE_MIN,
          f"int8_weights against bf16: {q_rel}, {q_agree}")
    check(b_agree >= ARGMAX_AGREE_MIN, f"bf16 against f32: {b_agree}")

    # argmax (bf16, the default) replayed through the f32 forward
    am = np.stack(G.batch_fast_generate(params, cfg, x0, h, [n - 1] * B, d,
                                        mode="argmax", device=dev))
    pred = replay_logits(params, cfg, am, h, d).argmax(-1)
    agree = float((pred[:, :40] == am[:, :40]).mean())
    phase("scan", f"argmax bf16 {n - 1} steps replayed through the f32 "
                  f"forward: 40-sample agreement {agree:.3f} (min "
                  f"{AGREE_MIN}), all steps {float((pred == am).mean()):.3f}")
    check(agree >= AGREE_MIN, f"scan argmax replay agreement {agree}")
    phase("mem", f"phase 12 (scan) peak device memory "
                 f"{peak_mib(dev):.1f} MiB | {card}")

    # ms/step beside K1's us/step at the same batch
    steps = up
    for Bt in (8, 20):
        args, kmaxd = bench.kernel_inputs(params, cfg, Bt, 4, seed=12)
        k_ms, _ = bench.cuda_ms(lambda: K.generate(
            *args, B=Bt, maxd=kmaxd, n_steps=4 * up, mode="sampling"))
        del args
        xs = torch.full((Bt, cfg.receptive_field(kmaxd) + 1), Q // 2,
                        dtype=torch.long, device=dev)
        hs = torch.as_tensor(rng.normal(size=(Bt, 1, cfg.n_aux)),
                             dtype=f32, device=dev)
        ds = torch.as_tensor(varying_d(rng, cfg, Bt, 1), device=dev)
        gen = torch.Generator(device=dev)
        times = []
        for name, dt, q in (("f32", f32, "none"), ("bf16", bf16, "none"),
                            ("int8_weights", bf16, "int8_weights")):
            def run():
                with torch.no_grad():
                    return G._generate_scan(params, cfg, xs, hs, ds, steps,
                                            kmaxd, "sampling", dt, q, True,
                                            generator=gen)
            med, lo, hi = median_ms(run, calls=SCAN_CALLS)
            times.append(f"{name} {med / steps:.3f} ({lo / steps:.3f}-"
                         f"{hi / steps:.3f})")
        k_us = k_ms / (4 * up) * 1e3
        phase("time", f"scan B={Bt} maxd {kmaxd} sampling, ms/step, median "
                      f"(lowest-highest) of {SCAN_CALLS} calls of {steps} "
                      f"steps: "
                      f"{', '.join(times)}; K1 (bf16) {k_us:.2f} us/step at "
                      f"the same B | {card}")
    del params
    torch.cuda.empty_cache()


def reference_state_dict(cfg, seed):
    """A random state_dict in the reference's layout (the keys of
    tools/convert_checkpoint.py's docstring) at cfg's widths: each weight
    normal over sqrt(fan in), each bias normal x 0.01."""
    import torch
    Q, A, R, S = cfg.n_quantize, cfg.n_aux, cfg.n_resch, cfg.n_skipch
    shapes = {"causal.conv": (R, Q, 2),
              "upsampling.conv": (1, 1, 1, cfg.upsampling_factor)}
    for i in range(len(cfg.dilationsF)):
        for br in ("sigmoid", "tanh"):
            shapes[f"dilF_{br}.{i}.conv"] = (R, R, 2)
            shapes[f"auxF_1x1_{br}.{i}"] = (R, A, 1)
        shapes[f"skipF_1x1.{i}"] = (S, R, 1)
        shapes[f"resF_1x1.{i}"] = (R, R, 1)
    for i in range(len(cfg.dilationsA)):
        for br in ("sigmoid", "tanh"):
            shapes[f"dilA_{br}.{i}.convC"] = (R, R, 1)
            shapes[f"dilA_{br}.{i}.convP"] = (R, R, 1)
            shapes[f"auxA_1x1_{br}.{i}"] = (R, A, 1)
        shapes[f"skipA_1x1.{i}"] = (S, R, 1)
        shapes[f"resA_1x1.{i}"] = (R, R, 1)
    shapes["conv_post_1"] = (S, S, 1)
    shapes["conv_post_2"] = (Q, S, 1)
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, shape in shapes.items():
        fan = int(np.prod(shape[1:]))
        sd[key + ".weight"] = torch.randn(shape, generator=gen) / fan ** 0.5
        sd[key + ".bias"] = 0.01 * torch.randn(
            (1 if key == "upsampling.conv" else shape[0],), generator=gen)
    return sd


def tools_smoke(cfg, dev, card):
    """Phase 13: validation over in-memory windows, and a synthetic
    reference checkpoint converted, loaded onto the card and decoded
    through K1; returns the K1 launches of the converted decode."""
    import torch

    from qpnet_tpu_torch.bin import qpnet_validate as V
    from qpnet_tpu_torch.config import RunConfig
    from qpnet_tpu_torch.data import batcher as DB
    from qpnet_tpu_torch.models import generate as G
    from qpnet_tpu_torch.models.qpnet import init_params, params_from_numpy
    from qpnet_tpu_torch.ops import gen_kernel as K
    from qpnet_tpu_torch.tools import convert_checkpoint as C
    from qpnet_tpu_torch.train import step as TS
    from qpnet_tpu_torch.train.checkpoint import load_checkpoint
    from qpnet_tpu_torch.utils.yamlconf import read_validation_record
    torch.cuda.reset_peak_memory_stats()
    params = init_params(0, cfg, device=dev)
    utts, scaler = memory_corpus(cfg, seed=13)

    def windows():
        return DB.window_batches(
            DB.utterance_stream(utts, lambda u: u, shuffle=False,
                                loop=False), cfg,
            feat_transform=scaler.transform, batch_length=20000,
            batch_size=1, max_length=30000)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, losses = V.validation_loss(params, cfg, windows(), dev)
    wall = time.perf_counter() - t0
    step = TS.make_eval_step(cfg)
    want = [float(step(params, TS.batch_to_device(
        {k: v for k, v in b.items() if k != "window_lens"}, dev)))
        for b in windows()]
    check(len(losses) >= 2 and losses == want
          and mean == float(np.mean(want)) and np.isfinite(mean),
          f"validation loss {mean} {losses} against eval steps {want}")
    with tempfile.TemporaryDirectory() as tmp:
        V.record_result(tmp, "checkpoint-1000.pkl", mean)
        path = V.record_result(tmp, "checkpoint-final.pkl", mean + 1.0)
        rec = read_validation_record(path)
        check(rec == {"checkpoint-1000.pkl": mean,
                      "checkpoint-final.pkl": mean + 1.0},
              f"validation record {rec}")
        phase("tools", f"validation over {len(losses)} in-memory windows "
                       f"(T=30030, f32): mean loss {mean:.6f} = the mean of "
                       f"make_eval_step's, {wall:.3f} s; two appends read "
                       f"back with both keys")
        del params
        torch.cuda.empty_cache()

        # conversion: the reference's state_dict at the default widths
        ref, out = os.path.join(tmp, "ref.pkl"), os.path.join(tmp, "ck.pkl")
        conf = os.path.join(tmp, "model.conf")
        torch.save({"model": reference_state_dict(cfg, seed=13)}, ref)
        C.main(["--checkpoint", ref, "--out", out, "--config", conf])
        model = load_checkpoint(out)["model"]
        want = C.convert_state_dict(C.load_torch_checkpoint(ref), cfg)
        la, lb = TS.tree_leaves(model), TS.tree_leaves(want)
        check(len(la) == len(lb) and all(
            a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in zip(la, lb)), "converted leaves bit for bit")
        check(RunConfig.load(conf).model == cfg, "converted model.conf")
    params = params_from_numpy(model, dev)
    rng = np.random.default_rng(13)
    x, h, n_samples, d = make_inputs(rng, cfg, [2, 2])
    xf = rng.integers(0, cfg.n_quantize, (2, 2 * cfg.upsampling_factor))
    K.reset_launch_count()
    samples = G.batch_fast_generate(params, cfg, x, h, n_samples, d,
                                    seed=100, device=dev)
    logits = G.teacher_forced_logits(params, cfg, x, h, xf, d,
                                     engine="pallas", device=dev)
    launches = K.launch_count
    s = np.stack(samples)
    check(launches > 0, "the converted decode must launch K1")
    check(s.min() >= 0 and s.max() < cfg.n_quantize
          and np.isfinite(logits).all(), "converted decode outputs")
    phase("tools", f"converted {len(la)} leaves equal convert_state_dict's "
                   f"bit for bit; decoded 2 frames at B=2 through K1 "
                   f"(launches {launches}): samples in [{s.min()}, "
                   f"{s.max()}], forced logits finite, max |logit| "
                   f"{float(np.abs(logits).max()):.3f}")
    phase("mem", f"phase 13 (validation, conversion) peak device memory "
                 f"{peak_mib(dev):.1f} MiB | {card}")
    del params
    torch.cuda.empty_cache()
    return launches


SOAK_MINUTES = 0.25  # the tool's default is 10; the run's time limit


def soak_smoke(dev, card):
    """Phase 14: the serving soak on the default net, bf16, 8 streams,
    SOAK_MINUTES of 1.0 s utterances; returns K1's launches in it."""
    import torch

    from qpnet_tpu_torch.ops import gen_kernel as K
    from qpnet_tpu_torch.tools.serve_soak import run_soak
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_count()
    out = run_soak(minutes=SOAK_MINUTES, streams=8, seconds=1.0, device=dev,
                   verbose=False)
    launches = K.launch_count
    phase("soak", "summary " + json.dumps(out))
    phase("soak", f"default net bf16, 8 streams, {SOAK_MINUTES} min of 1.0 s "
                  f"utterances: ok {out['ok']}, {out['completions']} "
                  f"completions, prewarmed group sizes "
                  f"{out['prewarmed_buckets']} in {out['prewarm_s']} s, "
                  f"chunk latency median {out['chunk_latency_ms_median']} "
                  f"ms, p99 {out['chunk_latency_ms_p99']} ms, drift "
                  f"{out['chunk_latency_drift']}, RSS growth "
                  f"{out['rss_growth_mib']} MiB, K1 launches {launches}, "
                  f"peak device memory {peak_mib(dev):.1f} MiB | {card}")
    check(out["ok"] and out["completions"] > 0, f"soak: {out}")
    check(launches > 0, "the soak must launch K1")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 15: WORLD analysis on the card, and vocode ending in K1
# ---------------------------------------------------------------------------

# the device analysis against the host analysis: the JAX package's own
# device-vs-host gates (tests/test_jax_f0.py:86-90, 117-118;
# tests/test_jax_analysis.py:48-49, 102, 131-134), the spectral ones with
# the host F0 fed to both backends.  The max gates on D4C and codeap are
# held on those tests' own inputs; on the full-size utterances codeap is
# held to a median and to the share of values beyond 0.1 dB
# (dsp/world/gates.py says why).
F0_VOICING_MIN = 0.85        # voicing agreement
F0_BOTH_MIN = 0.4            # share of frames voiced in both
F0_MEDIAN_MAX = 1.0          # Hz, median |dF0| where both are voiced
F0_NEAR_MIN = 0.9            # share of those within 10 Hz
VOCODE_FRAMES = 4            # frames of the forced K1 check at vocode's shape


def f0_gates(f0_dev, f0_host, tag):
    """The JAX package's F0 gates, device against host; returns the line."""
    vd, vh = f0_dev > 0, f0_host > 0
    both = vd & vh
    diff = np.abs(f0_dev - f0_host)[both]
    agree, share = float((vd == vh).mean()), float(both.mean())
    med = float(np.median(diff)) if both.any() else float("inf")
    near = float((diff < 10.0).mean()) if both.any() else 0.0
    check(agree > F0_VOICING_MIN and share > F0_BOTH_MIN
          and med < F0_MEDIAN_MAX and near > F0_NEAR_MIN,
          f"{tag}: device F0 against host: voicing agreement {agree}, "
          f"both voiced {share}, median |dF0| {med}, within 10 Hz {near}")
    return (f"voicing agreement {agree:.4f} (min {F0_VOICING_MIN}), both "
            f"voiced {share:.3f}, median |dF0| {med:.4f} Hz (max "
            f"{F0_MEDIAN_MAX}), within 10 Hz {near:.4f}")


def gate_inputs(dev):
    """The device spectral stages on the card against the host backend on
    the JAX package's own gate inputs, with their max gates (gates.py; the
    D4C signal at its test's 22,050 Hz)."""
    from qpnet_tpu_torch.dsp.world import gates
    m = gates.gate_metrics(dev, d4c_fs=FS)
    phase("analysis", f"the JAX package's gate inputs on the card: "
                      f"CheapTrick |d| median {m['ct_median_db']:.2e} dB "
                      f"(max {gates.CT_MEDIAN_DB}), mean "
                      f"{m['ct_mean_db']:.2e} dB (max {gates.CT_MEAN_DB}); "
                      f"D4C max |d| {m['d4c_max_db']:.2e} dB (max "
                      f"{gates.D4C_MAX_DB}), voicing equal "
                      f"{m['d4c_same_voicing']}; analyzer F0 equal "
                      f"{m['an_f0_equal']}, mcep c0 mean |d| "
                      f"{m['an_mcep_c0_mean']:.2e}, mean |d| "
                      f"{m['an_mcep_mean']:.2e}, codeap max |d| "
                      f"{m['an_codeap_max_db']:.2e} dB (max "
                      f"{gates.CODEAP_MAX_DB})")
    failed = gates.gate_failures(m)
    check(not failed, f"device spectral stages on the JAX package's gate "
                      f"inputs: {failed}")


# the analysis's sequential stages as kernels (ops/world_kernel.py), each
# with the JAX stage it replaces: no Pallas kernel, a loop that jax.jit
# compiles into the pass's one XLA program
WK_ROWS = {
    "pool": ("W1 pool_kernel", "qpnet_tpu/dsp/world/jax_f0.py:193"),
    "viterbi": ("W2 viterbi_kernel", "qpnet_tpu/dsp/world/jax_f0.py:291"),
    "fix_contour": ("W3 fix_contour_kernel",
                    "qpnet_tpu/dsp/world/jax_f0.py:447"),
    "smooth": ("W4 smooth_kernel", "qpnet_tpu/dsp/world/jax_analysis.py:214"),
}
# the calls of each kernel in one fused pass, harvest and dio
WK_HARVEST = {"pool": 1, "viterbi": 1, "fix_contour": 0, "smooth": 4}
WK_DIO = {"pool": 0, "viterbi": 0, "fix_contour": 1, "smooth": 4}
HBM_BYTES_S = 3.35e12        # H100 SXM device memory
F32_OPS_S = 67e12            # H100 SXM float32 outside the tensor cores,
                             # counting a fused multiply-add as two
# world_kernel.cu is built -fmad=false: each multiply and add is its own
# instruction, so its operations run at half the fused rate
WK_OPS_S = F32_OPS_S / 2
# the first designs of W1-W4 (a thread a frame, one warp a Viterbi with a
# lane a state, one warp's shuffles a DIO frame, one bin a thread): device
# ms per pass by pass length, recorded by this phase on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md section 6); printed beside this run's times as a
# record only, never put in the kernels line, which carries this run's
# measurements
WK_BEFORE_MS = {3: {"pool": 0.0435, "viterbi": 0.2736, "smooth": 0.0543,
                  "fix_contour": 0.1706},
              10: {"pool": 0.0434, "viterbi": 0.9046, "smooth": 0.1471}}


def wk_counts():
    from qpnet_tpu_torch.ops import world_kernel as WK
    return {k: WK.launch_count(k) for k in WK.KERNELS}


def wk_bits(got, want):
    """(got has want's shape and bits, max |got - want|)."""
    import torch
    torch.cuda.synchronize()
    same = (got.shape == want.shape and torch.equal(
        got.view(torch.int32), want.view(torch.int32)))
    return same, 0.0 if same else float((got - want).abs().max())


def wk_hold(calls, tag, errs, what="on the pass's own inputs"):
    """Each recorded call's kernel against its plain version on the same
    inputs, bit for bit; folds each kernel's max |d| into errs."""
    import torch
    from qpnet_tpu_torch.ops import world_kernel as WK
    for name, args in calls:
        got = getattr(WK, name)(*args)
        want = getattr(WK, name + "_reference")(*args)
        same, d = wk_bits(got, want)
        check(same, f"{tag}: {WK_ROWS[name][0]} at "
                    f"{[tuple(a.shape) for a in args if hasattr(a, 'shape')]}"
                    f" differs from its plain version, max |d| {d}")
        errs[name] = max(errs.get(name, 0.0), d)
    phase("analysis", f"{tag}: " + ", ".join(
        f"{WK_ROWS[n][0]} x{sum(c == n for c, _ in calls)}"
        for n in WK.KERNELS if any(c == n for c, _ in calls))
        + f" bit-equal to their plain versions {what}")


def wk_pass(dv, x, dim, alpha, tag, want, errs):
    """A warm-up pass of dv.extract_all with W1-W4's calls recorded and
    held to their plain versions (wk_hold), then the pass queued under
    sync debug mode "error" with W1-W4's launches counted (they must be
    `want`).  Returns (the fetched features, the launches, the calls)."""
    import torch
    from qpnet_tpu_torch.ops import world_kernel as WK
    from qpnet_tpu_torch.ops import world_kernel_cases as CASES
    with CASES.recording() as calls:
        dv.extract_all(x, dim, alpha)
    wk_hold(calls, tag, errs)
    WK.reset_launch_count()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = dv.extract_all_async(x, dim, alpha)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = wk_counts()
    check(counts == want, f"{tag}: W1-W4 launches {counts}, want {want}")
    return dv.extract_all_fetch(handle), counts, calls


def wk_work(name, args):
    """(bytes, float32 operations) a call must move and do: each input read
    once, the output written once (W2's back-pointers are scratch); every
    multiply and add counts once (W4: 2 F W n_off, at WK_OPS_S)."""
    if name == "pool":
        f, _, _, K = args
        n_ch, F = f.shape
        return 4 * (2 * n_ch * F + F * K), n_ch * F * (5 * K + 2)
    if name == "viterbi":
        emits, logf = args[:2]
        F, S = emits.shape
        return 4 * (emits.numel() + 2 * logf.numel() + F), 5 * (F - 1) * S * S
    if name == "fix_contour":
        F, C = args[1].shape
        return 4 * (2 * F + F * C), 2 * F * (3 * C + 6)
    ext, ov = args
    F, n_off = ov.shape
    W = ext.shape[1] - n_off
    return 4 * (ext.numel() + ov.numel() + F * W), 2 * F * W * n_off


def wk_chain_ms(name, steps):
    """Device ms of the chain probe of W2 or W3 over `steps` dependent
    steps (world_kernel.chain_probe): the floor of that kernel's frame
    chain on this card."""
    import torch
    from qpnet_tpu_torch.ops import world_kernel as WK
    from qpnet_tpu_torch.ops import world_kernel_cases as CASES
    inp = torch.rand(96, generator=torch.Generator().manual_seed(steps)).cuda()
    return CASES.device_ms(lambda: WK.chain_probe(name, steps, inp))


def wk_floor_ms(name, dims):
    """Device ms of an empty launch with W1's or W3's grid, block and shared
    memory for dims (world_kernel.launch_floor): the floor of that
    kernel's launch on this card."""
    import torch
    from qpnet_tpu_torch.ops import world_kernel as WK
    from qpnet_tpu_torch.ops import world_kernel_cases as CASES
    dev = torch.device("cuda", torch.cuda.current_device())
    return CASES.device_ms(lambda: WK.launch_floor(name, dims, dev))


def wk_times(calls, names, plain=True):
    """Per kernel of `names`, summed over its recorded calls of one pass:
    the kernel's device ms (CASES.device_ms, on contiguous copies of the
    inputs), the wrapper call's ms between CUDA events (the host's work
    included; the median of 10), the plain version's ms likewise (median
    of 3; not with plain=False), the bound, for W1 and W3 an empty launch
    with their grid, block and shared memory, for W2 and W3 their chain
    probe's device ms (the forward's F - 1 steps; W3's two walks, 2 F - 1:
    the floor of a walk over every frame), and for W4 the device ms of one
    grouped conv1d computing the same sums (float32, no TF32) with its
    largest relative distance."""
    import torch
    from qpnet_tpu_torch.ops import world_kernel as WK
    from qpnet_tpu_torch.ops import world_kernel_cases as CASES
    out = {}
    for name, args in calls:
        if name not in names:
            continue
        r = out.setdefault(name, {"calls": 0, "ms": 0.0, "call_ms": 0.0,
                                  "plain_ms": 0.0, "bytes": 0, "ops": 0,
                                  "library_ms": None})
        kernel = getattr(WK, name)
        dense = [a.contiguous() if torch.is_tensor(a) else a for a in args]
        r["calls"] += 1
        r["ms"] += CASES.device_ms(lambda: kernel(*dense))
        r["call_ms"] += median_ms(lambda: kernel(*args), calls=10)[0]
        if plain:
            r["plain_ms"] += median_ms(
                lambda: getattr(WK, name + "_reference")(*args), calls=3)[0]
        b, o = wk_work(name, args)
        r["bytes"] += b
        r["ops"] += o
        if name in ("pool", "fix_contour"):
            r["floor_ms"] = r.get("floor_ms", 0.0) + wk_floor_ms(
                name, args[0].shape if name == "pool" else args[1].shape)
        if name in ("viterbi", "fix_contour"):
            F = args[0].shape[0]
            r["chain_ms"] = r.get("chain_ms", 0.0) + wk_chain_ms(
                name, F - 1 if name == "viterbi" else 2 * F - 1)
        if name == "smooth":
            ext, ov = args

            def conv():
                return torch.nn.functional.conv1d(
                    ext[None], ov[:, None, :], groups=ov.shape[0])[
                        0, :, :ext.shape[1] - ov.shape[1]]
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                r["library_ms"] = (r["library_ms"] or 0.0) + CASES.device_ms(
                    conv)
                ref = WK.smooth_reference(*args)
                rel = float(((conv() - ref).abs()
                             / ref.abs().clamp_min(1e-30)).max())
            r["library_rel"] = max(r.get("library_rel", 0.0), rel)
    for r in out.values():
        t_bytes, t_ops = r["bytes"] / HBM_BYTES_S, r["ops"] / WK_OPS_S
        r["bound_ms"] = max(t_bytes, t_ops) * 1e3
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def wk_time_line(tag, secs, times, card):
    """The kernels' device ms per pass beside the first design's recorded
    time (WK_BEFORE_MS, not measured in this run), the bound (and W2's and
    W3's chain probe, W1's and W3's empty launch) with the share of the
    largest of them the kernel reaches."""
    def one(n, r):
        # W3 walks only the frames its carry decides, so its chain probe
        # (a step at every frame) is no floor of it
        floors = {"bound": r["bound_ms"], "empty launch": r.get("floor_ms", 0),
                  "chain probe": r.get("chain_ms", 0) if n == "viterbi" else 0}
        of = max(floors, key=floors.get)
        floor = floors[of]
        before = WK_BEFORE_MS.get(round(secs), {}).get(n)
        return (f"{WK_ROWS[n][0]} x{r['calls']} device {r['ms']:.4f} (the "
                f"first design's recorded time, not measured here, "
                + (f"{before:.4f}" if before else "none at this length")
                + f"; the wrapper call {r['call_ms']:.4f}; plain "
                + (f"{r['plain_ms']:.3f}" if r["plain_ms"] else "not timed")
                + f"; bound {r['bound_ms']:.5f} by {r['bound_by']}"
                + (f", chain probe {r['chain_ms']:.4f}" if "chain_ms" in r
                   else "")
                + (f", empty launch with its grid {r['floor_ms']:.4f}"
                   if "floor_ms" in r else "")
                + f"; share of the {of} {floor / r['ms']:.3f}"
                + (f"; grouped conv1d device {r['library_ms']:.4f}, max rel "
                   f"|d| {r['library_rel']:.1e}"
                   if r["library_ms"] is not None else "") + ")")
    phase("time", f"{tag}, ms per pass (calls a pass): "
                  + "; ".join(one(n, r) for n, r in times.items())
                  + f" | {card}")


# W2's and W4's edge inputs (ops/world_kernel_cases.py), held on the card:
# (seed, F, K) for W2 (K = 6 is harvest's; F = 11703 and 5121 fill the
# back-pointers' shared memory at S = 7 and 16), past that capacity (the
# spill branch: S = 16 at 15001 and 6001 frames, S = 7 at 12001 and 11800,
# each on its own seed), and (F, W, n_off) for W4 (CheapTrick's and D4C's
# widths at 22,050 Hz, D4C at f0_ceil 1000 Hz, 16 kHz CheapTrick, and short
# rows)
WK_VITERBI_EDGES = [(0, 601, 6), (1, 2001, 6), (2, 200, 15), (3, 130, 2),
                    (4, 33, 6), (5, 1, 6), (6, 2, 6), (7, 260, 8),
                    (8, 150, 3), (9, 129, 1), (10, 11703, 6),
                    (11, 5121, 15)]
WK_VITERBI_SPILL = [(12, 15001, 15), (13, 12001, 6), (14, 6001, 15),
                    (15, 11800, 6)]
WK_SPILL_REPEATS = 4   # kernel calls a spill input, each held to the plain
WK_SMOOTH_EDGES = [(601, 513, 20), (2001, 1025, 42), (601, 1025, 98),
                   (257, 257, 30), (5, 7, 6), (3, 2, 1)]


def wk_edges(errs, card):
    """W2 and W4 bit for bit against their plain versions on the CPU
    tests' edge inputs moved to the card (ties, NaN, +-inf, +-0, 1e30; the
    tile remainders), W2 at the shared-memory capacity and past it (the
    spill branch, kernel only: no pass is that long) at S = 16 and S = 7 on
    four seeds, each spill input WK_SPILL_REPEATS times (every call equal
    to the plain version, so to the others).  Returns the spill branch's
    device ms on the first spill input, also printed a frame."""
    import torch
    from qpnet_tpu_torch.ops import world_kernel as WK
    from qpnet_tpu_torch.ops import world_kernel_cases as CASES
    check(WK.viterbi_back_smem() == WK.VITERBI_BACK_SMEM,
          f"W2's built capacity {WK.viterbi_back_smem()} != "
          f"{WK.VITERBI_BACK_SMEM}")
    calls = []
    for seed, F, K in WK_VITERBI_EDGES + WK_VITERBI_SPILL:
        arrs = CASES.viterbi_edge_inputs(seed, F, K)
        calls.append(("viterbi", tuple(torch.from_numpy(a).cuda()
                                       for a in arrs)
                      + (CASES.TRANSITION_COST, CASES.UNVOICED_COST)))
    for F, W, n_off in WK_SMOOTH_EDGES:
        arrs = CASES.smooth_edge_inputs(F * W + n_off, F, W, n_off)
        calls.append(("smooth", tuple(torch.from_numpy(a).cuda()
                                      for a in arrs)))
    spills = [WK.viterbi_spills(a[0].shape[0], a[0].shape[1] - 1)
              for n, a in calls if n == "viterbi"]
    check(spills == [False] * len(WK_VITERBI_EDGES)
          + [True] * len(WK_VITERBI_SPILL), f"W2's edge inputs: spills {spills}")
    n_edges = len(WK_VITERBI_EDGES)
    spilled = calls[n_edges:n_edges + len(WK_VITERBI_SPILL)]
    wk_hold(calls[:n_edges] + calls[n_edges + len(spilled):],
            "edge inputs (ties, NaN, +-inf, 1e30, tile remainders; W2 at its "
            "shared capacity)", errs, "on them")
    # the spill branch: each input's plain version once, every one of
    # WK_SPILL_REPEATS kernel calls held to it
    for _, args in spilled:
        want = WK.viterbi_reference(*args)
        for i in range(WK_SPILL_REPEATS):
            same, d = wk_bits(WK.viterbi(*args), want)
            check(same, f"W2's spill branch at {tuple(args[0].shape)}, call "
                        f"{i + 1}, differs from its plain version, max |d| "
                        f"{d}")
    phase("analysis", f"W2's spill branch: {WK_SPILL_REPEATS} calls on each "
                      f"of {[tuple(a[0].shape) for _, a in spilled]} "
                      f"(emits; S = 16 and 7, four seeds) bit-equal to the "
                      f"plain version")
    spill = spilled[0][1]
    F, S = spill[0].shape
    ms = CASES.device_ms(lambda: WK.viterbi(*spill), calls=3)
    phase("time", f"W2's spill branch (S = {S}, {F} frames, back-pointers "
                  f"{(F - 1) * S} bytes in device memory): device "
                  f"{ms:.4f} ms = {ms / F * 1e6:.1f} ns a frame | {card}")
    return ms


# W1's and W3's edge inputs (ops/world_kernel_cases.py), held on the card:
# (seed, n_ch, F, K, agreeing +inf) for W1 (1-97 ranks around the warp's 32
# lanes, K 1-16, harvest's 81 x 6; F = 1 and tiles left ragged; K = 2 for
# the ranks after an agreeing +inf), (seed, F, C, kind) for W3 (C = 1, 7
# and 32; F = 1 and 2; all-unvoiced and all-voiced); W3's inputs past its
# shared memory are world_kernel_cases.FIX_CONTOUR_LONG
WK_POOL_EDGES = [(0, 81, 37, 6, False), (1, 1, 9, 1, False),
                 (2, 31, 17, 6, False), (3, 33, 16, 15, False),
                 (4, 97, 23, 16, False), (5, 81, 8, 16, True),
                 (6, 40, 1, 6, False), (7, 64, 12, 1, True),
                 (8, 81, 2001, 6, True), (9, 33, 9, 2, True)]
WK_FIX_EDGES = [(0, 200, 7, "mixed"), (1, 200, 7, "mixed"), (2, 1, 7, "mixed"),
                (3, 2, 1, "mixed"), (4, 150, 32, "mixed"),
                (5, 60, 7, "unvoiced"), (6, 60, 32, "voiced"),
                (7, 601, 7, "mixed"), (8, 90, 1, "mixed"),
                (9, 120, 16, "mixed")]
WK_EDGE_REPEATS = 4   # kernel calls an edge input, each held to the plain


def wk_hold_repeats(name, args, what):
    """WK_EDGE_REPEATS calls of kernel `name` on args, each bit-equal to
    one call of its plain version; returns max |d| (0)."""
    from qpnet_tpu_torch.ops import world_kernel as WK
    want = getattr(WK, name + "_reference")(*args)
    for i in range(WK_EDGE_REPEATS):
        same, d = wk_bits(getattr(WK, name)(*args), want)
        check(same, f"{WK_ROWS[name][0]} on {what}, call {i + 1}, differs "
                    f"from its plain version, max |d| {d}")
    return 0.0


def wk_pool_contour_edges(dev, card, x_long, errs):
    """W1 and W3 bit for bit against their plain versions, each input
    WK_EDGE_REPEATS times: on the CPU tests' edge inputs moved to the card
    (W1: NaN, the 5% edge, tiny candidates, an agreeing +inf, 1-97 ranks,
    K 1-16; W3: ties, NaN, the 10% edge, gaps at either end, C = 1-32), on
    the W3 input of a DIO F0 pass over x_long (device_dio alone, 40-400 Hz
    as the dio leg; no spectral stages), and on W3 inputs too long for its
    shared memory (the walks on device memory), once the built kernel is
    seen to stage where world_kernel.fix_contour_staged says.  Times W3 on the x_long
    input beside its floors, and on the long inputs.  Returns (W3's times
    on the x_long input, the long inputs' device ms by (F, C))."""
    import torch
    from qpnet_tpu_torch.dsp.world import device_f0 as DF
    from qpnet_tpu_torch.ops import world_kernel as WK
    from qpnet_tpu_torch.ops import world_kernel_cases as CASES
    t0 = time.perf_counter()
    for seed, n_ch, F, K, inf in WK_POOL_EDGES:
        f, sp = (torch.from_numpy(a).to(dev) for a in CASES.pool_edge_inputs(
            seed, n_ch, F, agreeing_inf=inf))
        errs["pool"] = max(errs.get("pool", 0.0), wk_hold_repeats(
            "pool", (f, sp, CASES.AGREEMENT_THRESHOLD, K),
            f"edge input {(seed, n_ch, F, K)}"))
    for seed, F, C, kind in WK_FIX_EDGES:
        s2, c = (torch.from_numpy(a).to(dev) for a in
                 CASES.fix_contour_edge_inputs(seed, F, C, kind))
        errs["fix_contour"] = max(errs.get("fix_contour", 0.0),
                                  wk_hold_repeats(
            "fix_contour", (s2, c, CASES.ALLOWED_RANGE),
            f"edge input {(seed, F, C, kind)}"))
    phase("analysis", f"W1 on {len(WK_POOL_EDGES)} and W3 on "
                      f"{len(WK_FIX_EDGES)} edge inputs (NaN, ties, the 5% "
                      f"and 10% edges, tiny and +inf candidates, 1-97 "
                      f"ranks, K 1-16, C 1-32, F 1-2001), "
                      f"{WK_EDGE_REPEATS} calls each: bit-equal to their "
                      f"plain versions")
    # W3 on a DIO pass's own input at x_long's length
    secs = len(x_long) / FS
    with CASES.recording() as calls:
        DF.device_dio(x_long, FS, n_valid=len(x_long), f0_floor=40.0,
                      f0_ceil=400.0, frame_period=5.0, device=dev)
    calls = [c for c in calls if c[0] == "fix_contour"]
    check(len(calls) == 1, f"device_dio made {len(calls)} W3 calls")
    args = calls[0][1]
    errs["fix_contour"] = max(errs["fix_contour"], wk_hold_repeats(
        "fix_contour", args, f"the {secs:g} s DIO input"))
    times = wk_times(calls, ("fix_contour",), plain=False)
    wk_time_line(f"W3 on the {secs:g} s DIO input {tuple(args[1].shape)}",
                 secs, times, card)
    # the built W3 stages where its Python copy says: on this input, the
    # long ones and either side of the shared-memory edge (SMEM_MAX)
    dims = [tuple(args[1].shape)] + [(F, C) for _, F, C in
                                     CASES.FIX_CONTOUR_LONG]
    for C in (1, 7, 32):
        most = WK.SMEM_MAX // (4 * (C + 2))
        dims += [(most, C), (most + 1, C)]
    staged = [(WK.fix_contour_staged(*d), WK.fix_staged_built(*d))
              for d in dims]
    check(all(a == b for a, b in staged), f"W3 staged (Python, built) at "
                                          f"{dims}: {staged}")
    long_ms = {}
    for seed, F, C in CASES.FIX_CONTOUR_LONG:
        s2, c = (torch.from_numpy(a).to(dev) for a in
                 CASES.fix_contour_edge_inputs(seed, F, C))
        check(not WK.fix_contour_staged(F, C)
              and not WK.fix_staged_built(F, C),
              f"W3 at {(F, C)} must walk device memory")
        wk_hold_repeats("fix_contour", (s2, c, CASES.ALLOWED_RANGE),
                        f"the long input {(F, C)}")
        long_ms[(F, C)] = CASES.device_ms(
            lambda: WK.fix_contour(s2, c, CASES.ALLOWED_RANGE), calls=3)
    phase("time", f"W3 past its shared memory (walks on device memory), "
                  f"{WK_EDGE_REPEATS} calls each bit-equal to the plain "
                  f"version: device " + ", ".join(
                      f"{ms:.4f} ms = {ms / F * 1e6:.1f} ns a frame at "
                      f"{(F, C)}" for (F, C), ms in long_ms.items())
                  + f" | {card}")
    phase("analysis", f"W1's and W3's edge, {secs:g} s and long checks "
                      f"took {time.perf_counter() - t0:.1f} s")
    return times["fix_contour"], long_ms


# the wide branches of W1-W3 (past 16 slots, 16 states, 32 candidates; the
# CPU tests' wide inputs, tests/test_torch_port_world_wide.py): (seed,
# n_ch, F, K, ladder, agreeing +inf) for W1, K = 17, 64 and 255, K past
# the ranks, a 10 s frame count; (seed, F, K) for W2, S = 17, 33, 129 and
# 256, the last past the back-pointers' shared memory (the spill branch);
# (seed, F, C, kind) for W3, C = 33, 64, 100 and 256, 256 both staged (150
# frames) and on device memory (601)
WK_POOL_WIDE = [(50, 40, 9, 17, 30, False), (51, 200, 9, 64, 150, True),
                (52, 600, 5, 255, 500, True), (53, 97, 7, 255, 0, False),
                (55, 1500, 4, 255, 1200, True), (56, 84, 2001, 31, 84, False)]
WK_VITERBI_WIDE = [(40, 2001, 16), (41, 601, 32), (42, 601, 128),
                   (44, 400, 255)]
WK_FIX_WIDE = [(60, 200, 33, "mixed"), (61, 200, 64, "mixed"),
               (62, 150, 256, "mixed"), (63, 601, 256, "mixed"),
               (65, 250, 100, "voiced")]
WK_WIDE_K = (31, 127)          # W1 and W2 timed at these K, 10 s
WK_WIDE_OCTAVE = {42: 12.0, 256: 73.0}   # W3 timed at these C (DIO's
                                         # bands an octave over 71-800 Hz)


def wk_wide(dev, card, x, pool_10s, errs):
    """Phase 15's wide branches: W1, W2 and W3 past their narrow builds,
    each input WK_EDGE_REPEATS calls bit-equal to its plain version: the
    CPU tests' wide edge inputs; a device_harvest(max_candidates=31) and a
    device_dio(channels_in_octave=12) pass over x (3 s; harvest at 40-400
    Hz as the analysis, DIO at its 71-800 Hz, C = 42) queued and counted,
    their F0 held to the host's harvest and dio + stonemask on the JAX
    package's gates, and their W1-W3 inputs held; W3's input of a DIO pass
    at 73 bands an octave (C = 256, on device memory).  Times W1 and W2 at
    K = 31 and 127 on 10 s inputs (W1: the 10 s pass's ranks, pool_10s;
    W2: harvest-like candidates, 2,001 frames) and W3 at C = 42 and 256 on
    the 3 s DIO inputs, each beside its plain version and bound.  Returns
    ({kernel: {"ms_by_input", "plain_ms_by_input"}}, the passes' W1-W4
    launches by path)."""
    import torch
    from qpnet_tpu_torch.dsp.world import device_f0 as DF
    from qpnet_tpu_torch.dsp.world.dio import dio
    from qpnet_tpu_torch.dsp.world.harvest import harvest
    from qpnet_tpu_torch.dsp.world.stonemask import stonemask
    from qpnet_tpu_torch.ops import world_kernel as WK
    from qpnet_tpu_torch.ops import world_kernel_cases as CASES
    t0 = time.perf_counter()
    held = {"pool": 0, "viterbi": 0, "fix_contour": 0}

    def hold(name, args, what):
        errs[name] = max(errs.get(name, 0.0),
                         wk_hold_repeats(name, args, what))
        held[name] += 1

    for seed, n_ch, F, K, ladder, inf in WK_POOL_WIDE:
        f, sp = (torch.from_numpy(a).to(dev) for a in CASES.pool_edge_inputs(
            seed, n_ch, F, agreeing_inf=inf, ladder=ladder))
        hold("pool", (f, sp, CASES.AGREEMENT_THRESHOLD, K),
             f"wide input {(seed, n_ch, F, K)}")
    spills = []
    for seed, F, K in WK_VITERBI_WIDE:
        arrs = CASES.viterbi_edge_inputs(seed, F, K)
        spills.append(WK.viterbi_spills(F, K))
        hold("viterbi", tuple(torch.from_numpy(a).to(dev) for a in arrs)
             + (CASES.TRANSITION_COST, CASES.UNVOICED_COST),
             f"wide input {(seed, F, K + 1)} (F, S)")
    check(spills == [False] * (len(WK_VITERBI_WIDE) - 1) + [True],
          f"W2's wide inputs: spills {spills}")
    staged = []
    for seed, F, C, kind in WK_FIX_WIDE:
        s2, c = (torch.from_numpy(a).to(dev) for a in
                 CASES.fix_contour_edge_inputs(seed, F, C, kind))
        staged.append(WK.fix_contour_staged(F, C))
        hold("fix_contour", (s2, c, CASES.ALLOWED_RANGE),
             f"wide input {(seed, F, C, kind)}")
    dims = [(F, C) for _, F, C, _ in WK_FIX_WIDE]
    for C in (33, 64, 256):
        most = WK.SMEM_MAX // (4 * (C + 2))
        dims += [(most, C), (most + 1, C)]
    built = [(WK.fix_contour_staged(*d), WK.fix_staged_built(*d))
             for d in dims]
    check(staged[2:4] == [True, False] and all(a == b for a, b in built),
          f"W3's wide staging (Python, built) at {dims}: {built}")
    phase("analysis", f"wide branches on the CPU tests' wide inputs, "
                      f"{WK_EDGE_REPEATS} calls each bit-equal to the plain "
                      f"versions: W1 on {len(WK_POOL_WIDE)} (K 17-255, 4-1500 "
                      f"ranks), W2 on {len(WK_VITERBI_WIDE)} (S 17-256, the "
                      f"last spilled), W3 on {len(WK_FIX_WIDE)} (C 33-256, "
                      f"staged and on device memory)")

    # the passes at K = 31 and C = 42, queued, counted, held to the host
    # (the signal uploaded first: an upload from pageable memory syncs)
    secs = len(x) / FS
    xd = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    paths, w3_in = {}, {}
    runs = {
        "harvest_k31": lambda: DF.device_harvest(
            xd, FS, n_valid=len(x), f0_floor=40.0, f0_ceil=400.0,
            max_candidates=31),
        "dio_c42": lambda: DF.device_dio(
            xd, FS, n_valid=len(x), channels_in_octave=WK_WIDE_OCTAVE[42]),
        "dio_c256": lambda: DF.device_dio(
            xd, FS, n_valid=len(x), channels_in_octave=WK_WIDE_OCTAVE[256])}
    for tag, run in runs.items():
        with CASES.recording() as calls:
            run()
        for name, args in calls:
            hold(name, args, f"the {secs:g} s {tag} pass's input")
            if name == "fix_contour":
                w3_in[args[1].shape[1]] = args
        WK.reset_launch_count()
        torch.cuda.set_sync_debug_mode("error")
        try:
            f0 = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        paths[f"{tag}_{secs:g}s"] = wk_counts()
        if tag == "harvest_k31":
            f0_h, _ = harvest(x, FS, f0_floor=40.0, f0_ceil=400.0,
                              max_candidates=31)
        elif tag == "dio_c42":
            raw, ta = dio(x, FS, channels_in_octave=WK_WIDE_OCTAVE[42])
            f0_h = stonemask(x, raw, ta, FS)
            f0 = DF.device_stonemask(xd, f0, FS, n_valid=len(x))
        else:
            continue
        phase("analysis", f"{tag} ({secs:g} s): W1-W4 launches "
                          f"{paths[f'{tag}_{secs:g}s']}; device F0 against "
                          f"the host's: " + f0_gates(
                              f0.cpu().numpy()[:len(f0_h)], f0_h, tag))
    want = {"harvest_k31": {"pool": 1, "viterbi": 1, "fix_contour": 0,
                            "smooth": 0},
            "dio_c42": {"pool": 0, "viterbi": 0, "fix_contour": 1,
                        "smooth": 0}}
    for tag, counts in want.items():
        check(paths[f"{tag}_{secs:g}s"] == counts,
              f"{tag}: W1-W4 launches {paths[f'{tag}_{secs:g}s']}")
    check(sorted(w3_in) == [42, 256], f"W3's pass inputs: C {sorted(w3_in)}")

    # the times: each new branch beside its plain version (one call after
    # a warm-up: no gate reads it) and bound; W1's and W2's 10 s inputs
    # held first, W3's were in their pass
    inputs = {}
    f, sp, thr, _ = pool_10s
    for K in WK_WIDE_K:
        inputs[("pool", f"harvest_10s_K{K}")] = (f, sp, thr, K)
        refined, score = CASES.harvest_like_inputs(K, f.shape[1], K)
        with CASES.recording() as calls:
            DF._viterbi(torch.from_numpy(refined).to(dev),
                        torch.from_numpy(score).to(dev),
                        CASES.TRANSITION_COST, CASES.UNVOICED_COST)
        inputs[("viterbi", f"harvest_like_10s_K{K}")] = calls[0][1]
    for (name, tag), args in inputs.items():
        hold(name, args, f"the {tag} input")
    for C, args in sorted(w3_in.items()):
        inputs[("fix_contour", f"dio_{secs:g}s_C{C}")] = args
    out = {n: {"ms_by_input": {}, "plain_ms_by_input": {},
               "bound_ms_by_input": {}} for n in held}
    line = []
    for (name, tag), args in inputs.items():
        kernel = getattr(WK, name)
        ms = CASES.device_ms(lambda: kernel(*args))
        plain = median_ms(lambda: getattr(WK, name + "_reference")(*args),
                          calls=1)[0]
        b, o = wk_work(name, args)
        bound = max(b / HBM_BYTES_S, o / WK_OPS_S) * 1e3
        out[name]["ms_by_input"][tag] = ms
        out[name]["plain_ms_by_input"][tag] = plain
        out[name]["bound_ms_by_input"][tag] = bound
        shape = tuple(args[1].shape if name == "fix_contour"
                      else args[0].shape)
        line.append(f"{WK_ROWS[name][0]} {tag} {shape} device {ms:.4f} "
                    f"(plain {plain:.3f}; bound {bound:.5f})")
    phase("time", "wide branches, ms a call: " + "; ".join(line)
                  + f" | {card}")
    phase("analysis", f"wide-branch checks: {held} inputs held, took "
                      f"{time.perf_counter() - t0:.1f} s")
    return out, paths


def analysis_smoke(dev, card):
    """Phase 15: WorldAnalyzer's fused device pass (extract_all, harvest)
    on synthetic 3 s and 10 s utterances at the port's AcousticConfig,
    held to the host analysis and to the staged device path, timed in
    whole and by stage, with its launches and peak memory; then K1 at the
    shape vocode gives it against its twins, and Vocoder.vocode of the 3 s
    utterance, analysis then K1.  The analysis's sequential stages run
    through W1-W4, each held to its plain version on the passes' own
    inputs, timed, and counted over the queued pass; the dio leg runs W3.
    Returns (vocode's K1 launches, the W1-W4 rows of the kernels line by
    kernel)."""
    import torch

    from qpnet_tpu_torch import Vocoder
    from qpnet_tpu_torch.bench import idle_share, kernel_events
    from qpnet_tpu_torch.config import AcousticConfig, ModelConfig
    from qpnet_tpu_torch.data.stats import Scaler
    from qpnet_tpu_torch.dsp.world import WorldAnalyzer, gates
    from qpnet_tpu_torch.dsp.world import device_f0 as DF
    from qpnet_tpu_torch.models.qpnet import init_params
    from qpnet_tpu_torch.ops import gen_kernel as K
    from qpnet_tpu_torch.ops import world_kernel as WK
    from qpnet_tpu_torch.ops.world_kernel_cases import PASS_SECONDS
    t_phase = time.perf_counter()
    ac = AcousticConfig(fs=FS, minf0=40.0, maxf0=400.0)
    dim, alpha = ac.mcep_dim, ac.mcep_alpha
    kw = dict(fs=FS, shiftms=ac.shiftms, minf0=ac.minf0, maxf0=ac.maxf0,
              fftl=ac.fftl)
    rng = np.random.default_rng(15)
    utts, errs, paths, times = {}, {}, {}, {}
    for secs in PASS_SECONDS:
        x = gates.voiced_utterance(rng, secs, FS)
        utts[secs] = x
        tag = f"analysis {secs:g} s"
        # the host analysis (float64 numpy), timed once
        host = WorldAnalyzer(**kw)
        t0 = time.perf_counter()
        f0_h, ta = host.estimate_f0(x)
        _, sp_h, _ = host.analyze(x, f0_time=(f0_h, ta))
        mc_h, ca_h = host.mcep(dim, alpha), host.codeap()
        host_ms = (time.perf_counter() - t0) * 1e3

        # the fused device pass: queued without a sync, one fetch (after a
        # warm-up call, which builds and uploads this length's constants)
        dv = WorldAnalyzer(backend="jax", f0_backend="jax", device=dev,
                           **kw)

        def fused():
            return dv.extract_all(x, dim, alpha)
        out, counts, calls = wk_pass(dv, x, dim, alpha, f"{tag} (harvest)",
                                     WK_HARVEST, errs)
        paths[f"analysis_{secs:g}s"] = counts
        pool_args = next(a for n, a in calls if n == "pool")
        F = len(f0_h)
        check(out["f0"].shape == (F,) and out["mcep"].shape == (F, dim + 1)
              and out["codeap"].shape == (F, 2) and out["npow"].shape == (F,)
              and all(np.isfinite(v).all() for v in out.values()),
              f"{tag}: fused outputs' shapes and finiteness")
        phase("analysis", f"{secs:g} s, {F} frames: extract_all queued with "
                          f"no sync, W1-W4 launches {counts}; fused device "
                          f"F0 against the host: "
                          + f0_gates(out["f0"], f0_h, tag))

        # the device spectral stages against the host's, given the host F0
        st = WorldAnalyzer(backend="jax", f0_backend="host", device=dev,
                           **kw)
        _, sp_d, _ = st.analyze(x, f0_time=(f0_h, ta))
        mc_d, ca_d = st.mcep(dim, alpha), st.codeap()
        floor = sp_h.max() * 1e-9
        err = np.abs(gates.db(np.maximum(sp_h[:, 4:-4], floor))
                     - gates.db(np.maximum(sp_d[:, 4:-4], floor)))
        c0 = float(np.abs(mc_h[:, 0] - mc_d[:, 0]).mean())
        mc = float(np.abs(mc_h - mc_d).mean())
        cm = gates.codeap_full_metrics(ca_h, ca_d)
        phase("analysis", f"{secs:g} s, host F0 in both: CheapTrick |d| "
                          f"median {np.median(err):.2e} dB (max "
                          f"{gates.CT_MEDIAN_DB}), mean {err.mean():.2e} dB "
                          f"(max {gates.CT_MEAN_DB}); mcep c0 mean |d| "
                          f"{c0:.2e} (max {gates.MCEP_C0_MAX}), mean |d| "
                          f"{mc:.2e} (max {gates.MCEP_MEAN_MAX}); codeap |d| "
                          f"median {cm['codeap_median_db']:.2e} dB (max "
                          f"{gates.CODEAP_MEDIAN_DB}), max "
                          f"{cm['codeap_max_db']:.4f} dB, "
                          f"{cm['codeap_n_over']} of {ca_h.size} beyond "
                          f"{gates.CODEAP_MAX_DB} dB = "
                          f"{cm['codeap_over']:.4f} (max "
                          f"{gates.CODEAP_OVER_MAX})")
        failed = gates.gate_failures(cm)
        check(np.median(err) < gates.CT_MEDIAN_DB
              and err.mean() < gates.CT_MEAN_DB and c0 < gates.MCEP_C0_MAX
              and mc < gates.MCEP_MEAN_MAX and not failed,
              f"{tag}: device spectral stages {failed}")

        # fused against staged, both on the card
        sg = WorldAnalyzer(backend="jax", f0_backend="jax", device=dev,
                           **kw)
        f0_s, _, _ = sg.analyze(x)
        d_mc = float(np.abs(out["mcep"] - sg.mcep(dim, alpha)).max())
        d_ca = float(np.abs(out["codeap"] - sg.codeap()).max())
        d_np = float(np.abs(out["npow"] - sg.npow()).max())
        phase("analysis", f"{secs:g} s fused against staged: F0 equal "
                          f"{np.array_equal(out['f0'], f0_s)}, max |d| mcep "
                          f"{d_mc:.2e} (max 1e-5), codeap {d_ca:.2e}, npow "
                          f"{d_np:.2e} (max 1e-4)")
        check(np.array_equal(out["f0"], f0_s) and d_mc <= 1e-5
              and d_ca <= 1e-4 and d_np <= 1e-4, f"{tag}: fused != staged")

        # times: 5 passes after the warm-up, the whole pass on the host
        # clock from the call to the fetch, and each pass split by stage
        # from its own CUDA events.  The device waits on the host through
        # most of a pass, so a stage's time is mostly the host's time to
        # queue its kernels, and the stages add up to the pass.
        walls, splits = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            with DF.stage_marks() as marks:
                t0 = time.perf_counter()
                DF.mark("start", dev)
                fused()
                DF.mark("fetch", dev)
                walls.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            splits.append(dict(DF.marks_ms(marks)))
        mid = int(np.argsort(walls)[len(walls) // 2])
        f0_ms = sum(v for k, v in splits[mid].items()
                    if k.startswith("F0"))
        events_ms = [sum(sp.values()) for sp in splits]
        events = kernel_events(fused)
        idle = idle_share([(ts, ts + dur) for _, ts, dur in events])
        torch.cuda.reset_peak_memory_stats()
        fused()
        phase("time", f"analysis {secs:g} s ({F} frames): device (fused "
                      f"extract_all, 5 passes after a warm-up, median "
                      f"(lowest-highest)) {walls[mid]:.3f} "
                      f"({min(walls):.3f}-{max(walls):.3f}) ms = "
                      f"{walls[mid] / secs:.3f} ms per second of audio; "
                      f"the stages' CUDA events of the same passes add up "
                      f"to {np.median(events_ms):.3f} "
                      f"({min(events_ms):.3f}-{max(events_ms):.3f}) ms; "
                      f"host {host_ms:.3f} ms = {host_ms / secs:.3f} ms/s "
                      f"(one call) | {card}")
        phase("time", f"analysis {secs:g} s by stage, ms of the median pass "
                      f"(share of its events' sum; lowest-highest over the "
                      f"5 passes): " + ", ".join(
                          f"{k} {v:.3f} ({v / events_ms[mid]:.3f}; "
                          f"{min(sp[k] for sp in splits):.3f}-"
                          f"{max(sp[k] for sp in splits):.3f})"
                          for k, v in splits[mid].items())
                      + f"; F0 in all {f0_ms:.3f} "
                      f"({f0_ms / events_ms[mid]:.3f}) | {card}")
        phase("time", f"analysis {secs:g} s: {len(events)} CUDA kernels "
                      f"per utterance (torch.profiler), device idle share "
                      f"{idle:.4f}; peak device memory {peak_mib(dev):.1f} "
                      f"MiB | {card}")
        times[secs] = wk_times(calls, ("pool", "viterbi", "smooth"))
        wk_time_line(f"W1, W2, W4 in the {secs:g} s harvest pass", secs,
                     times[secs], card)
        torch.cuda.empty_cache()

    spill_ms = wk_edges(errs, card)
    w3_long, w3_longest = wk_pool_contour_edges(dev, card,
                                                utts[PASS_SECONDS[-1]], errs)
    wide, wide_paths = wk_wide(dev, card, utts[PASS_SECONDS[0]], pool_args,
                               errs)
    paths.update(wide_paths)
    dio_path = f"analysis_dio_{PASS_SECONDS[0]:g}s"
    dio = dio_leg(dev, card, utts[PASS_SECONDS[0]], kw, dim, alpha, errs)
    paths[dio_path] = dio["counts"]
    gate_inputs(dev)

    # vocode: the 3 s utterance as int16 PCM through the default network
    # with random weights, conditioned by a scaler from its own features
    cfg = ModelConfig()
    up = cfg.upsampling_factor
    voc = Vocoder(init_params(0, cfg, device=dev), cfg, None, fs=FS,
                  device=dev)
    pcm = np.clip(utts[PASS_SECONDS[0]], -32768, 32767).astype(np.int16)
    feats = voc.analyze(pcm)
    check(feats.shape[1] == cfg.n_aux and np.isfinite(feats).all(),
          f"vocode features {feats.shape}")
    voc.scaler = Scaler.from_stats(feats.mean(0), feats.std(0) + 1e-3)

    # K1 at the shape vocode gives it: B=1, the utterance's maxd bucket,
    # VOCODE_FRAMES frames around its largest d, against its twins
    h, d = voc.conditioning(feats)
    path_shape_check(K, voc.params, cfg, h[None], d[None], VOCODE_FRAMES, rng,
                     dev, "vocode k1")

    t0 = time.perf_counter()
    voc.analyze(pcm)
    analysis_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_count()
    WK.reset_launch_count()
    t0 = time.perf_counter()
    wav = voc.vocode(pcm)
    wall = time.perf_counter() - t0
    launches = K.launch_count
    paths["vocode"] = wk_counts()
    check(paths["vocode"] == WK_HARVEST, f"vocode's analysis: W1-W4 "
                                         f"launches {paths['vocode']}")
    F = feats.shape[0]
    n_want = F * up - 1
    check(wav.shape == (n_want,) and np.isfinite(wav).all()
          and float(np.abs(wav).max()) > 1e-3 and float(wav.std()) > 1e-4,
          f"vocode output {wav.shape} (want {n_want}), max "
          f"{np.abs(wav).max()}, std {wav.std()}")
    check(launches > 0, "vocode must launch K1")
    phase("vocode", f"Vocoder(device=cuda).vocode of the "
                    f"{PASS_SECONDS[0]:g} s utterance (int16 PCM, default "
                    f"net, random weights, sampling): "
                    f"{wav.shape[0]} samples = F*up - 1 ({F} frames), "
                    f"finite, max |x| {float(np.abs(wav).max()):.4f}, std "
                    f"{float(wav.std()):.4f}; K1 launches {launches}; wall "
                    f"{wall:.3f} s, of which analyze (the same PCM, timed "
                    f"alone just before) {analysis_s:.3f} s, so synthesis "
                    f"through K1 {wall - analysis_s:.3f} s; W1-W4 "
                    f"launches {paths['vocode']}; peak device memory "
                    f"{peak_mib(dev):.1f} MiB | {card}")
    torch.cuda.empty_cache()
    # the rows: W1, W2, W4 as the 10 s harvest pass runs them, W3 as the
    # dio pass does
    rows = {}
    for name, (label, replaces) in WK_ROWS.items():
        main = (dio_path if name == "fix_contour"
                else f"analysis_{PASS_SECONDS[-1]:g}s")
        r = (dio["times"] if name == "fix_contour"
             else times[PASS_SECONDS[-1]])[name]
        rows[name] = {
            "name": label, "route": "cuda",
            "source": "qpnet_tpu_torch/csrc/world_kernel.cu",
            "replaces": replaces, "launches": paths[main][name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "main_path": main, "calls_per_pass": r["calls"],
            "launches_by_path": {p: c[name] for p, c in paths.items()}}
        for key in ("chain_ms", "floor_ms"):
            if key in r:
                rows[name][key] = r[key]
    rows["viterbi"]["spill_ms"] = spill_ms
    rows["fix_contour"]["ms_by_input"] = {
        f"dio_{PASS_SECONDS[-1]:g}s": w3_long["ms"],
        **{f"{F}x{C}": ms for (F, C), ms in w3_longest.items()}}
    # the wide branches' times, beside their plain versions and bounds
    for name, r in wide.items():
        for key, by in r.items():
            rows[name].setdefault(key, {}).update(by)
    phase("analysis", f"phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return launches, rows


def dio_leg(dev, card, x, kw, dim, alpha, errs):
    """Phase 15's dio leg: extract_all with device DIO and StoneMask on the
    3 s utterance, W1-W4 held to their plain versions on its inputs, the
    queued pass's launches, its F0 on the JAX package's gates against the
    host's dio and stonemask, 3 passes timed, its CUDA kernels and idle
    share.  Returns {"counts", "times"}."""
    import torch

    from qpnet_tpu_torch.bench import idle_share, kernel_events
    from qpnet_tpu_torch.dsp.world import WorldAnalyzer
    secs = len(x) / FS
    tag = f"analysis dio {secs:g} s"
    host = WorldAnalyzer(f0_analyzer="dio", **kw)
    t0 = time.perf_counter()
    f0_h, _ = host.estimate_f0(x)
    host_ms = (time.perf_counter() - t0) * 1e3
    dv = WorldAnalyzer(backend="jax", f0_backend="jax", device=dev,
                       f0_analyzer="dio", **kw)

    def fused():
        return dv.extract_all(x, dim, alpha)
    out, counts, calls = wk_pass(dv, x, dim, alpha, tag, WK_DIO, errs)
    F = len(f0_h)
    check(out["f0"].shape == (F,) and out["mcep"].shape == (F, dim + 1)
          and all(np.isfinite(v).all() for v in out.values()),
          f"{tag}: fused outputs' shapes and finiteness")
    phase("analysis", f"{tag}, {F} frames: extract_all (device DIO and "
                      f"StoneMask) queued with no sync, W1-W4 launches "
                      f"{counts}; F0 against the host's dio and stonemask: "
                      + f0_gates(out["f0"], f0_h, tag))
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused()
        walls.append((time.perf_counter() - t0) * 1e3)
    events = kernel_events(fused)
    idle = idle_share([(ts, ts + dur) for _, ts, dur in events])
    phase("time", f"{tag}: device (fused extract_all, 3 passes after a "
                  f"warm-up, median (lowest-highest)) {np.median(walls):.3f} "
                  f"({min(walls):.3f}-{max(walls):.3f}) ms = "
                  f"{np.median(walls) / secs:.3f} ms per second of audio; "
                  f"{len(events)} CUDA kernels per utterance, device idle "
                  f"share {idle:.4f}; host dio and stonemask {host_ms:.3f} "
                  f"ms (one call) | {card}")
    times = wk_times(calls, ("fix_contour",))
    wk_time_line(f"W3 in the {secs:g} s dio pass", secs, times, card)
    return {"counts": counts, "times": times}


# --- phase 16: the recipe's workers on the card ----------------------------

NS_SECONDS = (1.0, 1.3, 1.7, 2.0)   # the synthetic corpus of phase 16
NS_STREAMS = 3                      # TCP streams served with --noise_shaping
NS_FRAMES = 100                     # frames each stream plays (0.5 s)
NS_CHUNK = 5500                     # samples of a served chunk
NS_K1_FRAMES = 2                    # frames of the forced K1 checks


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _schema(sets):
    """Datasets with their dtypes and shapes; /vad_idx's length follows the
    frames' power, so only its rank counts."""
    return {k: (v.dtype, v.ndim if k == "vad_idx" else v.shape)
            for k, v in sets.items()}


def _recipe_corpus(root, rng):
    """NS_SECONDS of int16 voiced utterances under root/wav, the list of
    them, and the seconds of audio."""
    from scipy.io import wavfile

    from qpnet_tpu_torch.dsp.world import gates
    os.makedirs(os.path.join(root, "wav"))
    paths = []
    for i, secs in enumerate(NS_SECONDS):
        x = gates.voiced_utterance(rng, secs, FS)
        p = os.path.join(root, "wav", f"utt{i}.wav")
        wavfile.write(p, FS, np.clip(x, -32768, 32767).astype(np.int16))
        paths.append(p)
    lst = os.path.join(root, "wav.scp")
    with open(lst, "w") as f:
        f.write("\n".join(paths) + "\n")
    return paths, lst


H5_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "data", "h5_fixture")
H5_FIXTURE_FEATS = ("utt1", "utt2")   # its feature files, with stats.h5


def h5_times(feats, tmp):
    """The port's write_hdf5 and read_hdf5 per call on the recipe's feature
    files: each file's datasets written again one by one into a new file
    (as feature_extract writes them), then read; ms per call (median,
    lowest-highest) and MB/s of dataset bytes over all calls."""
    from qpnet_tpu_torch.data import read_hdf5, write_hdf5
    from qpnet_tpu_torch.data.hdf5_format import list_datasets
    w_ms, r_ms, nbytes = [], [], 0
    for i, src in enumerate(feats):
        sets = list_datasets(src)
        dst = os.path.join(tmp, "h5_times", f"{i}.h5")
        for k, v in sets.items():
            t0 = time.perf_counter()
            write_hdf5(dst, "/" + k, v)
            w_ms.append((time.perf_counter() - t0) * 1e3)
            nbytes += np.asarray(v).nbytes
        for k, v in sets.items():
            t0 = time.perf_counter()
            got = read_hdf5(dst, "/" + k)
            r_ms.append((time.perf_counter() - t0) * 1e3)
            check(np.asarray(got).tobytes() == np.asarray(v).tobytes(),
                  f"{dst} {k}: read back differs")
        size = os.path.getsize(dst)

    def line(name, ms):
        return (f"{name} {np.median(ms):.4f} ({min(ms):.4f}-{max(ms):.4f}) "
                f"ms per call, {nbytes / 1e6 / (sum(ms) / 1e3):.2f} MB/s")
    return (f"{len(w_ms)} datasets, {nbytes} bytes of data (the last file "
            f"{size} bytes): " + line("write_hdf5", w_ms) + "; "
            + line("read_hdf5", r_ms) + " (host clock)")


def h5_fixture_leg(dev, card, tmp, conf, ckpt, run_cfg, rng):
    """Phase 16's fixture leg: every dataset of the h5py-written fixture
    (tests/data/h5_fixture, tests/torch_port_h5_fixture.py) read bit for
    bit against its .npz twin; each file's datasets written again by the
    port's write_hdf5 into a copy and read back equal; `qpnet_decode.main`
    of its feature files with its stats at B=2 (default net, random
    weights seed 0) through K1, after K1 against its twins at that shape.
    Returns K1's launches in the decode."""
    import shutil

    import torch
    from scipy.io import wavfile

    from qpnet_tpu_torch.bin import qpnet_decode
    from qpnet_tpu_torch.data import load_scaler, read_hdf5, write_hdf5
    from qpnet_tpu_torch.data.hdf5_format import list_datasets
    from qpnet_tpu_torch.models.qpnet import init_params
    from qpnet_tpu_torch.ops import gen_kernel as K
    t_leg = time.perf_counter()
    cfg = run_cfg.model
    twin = np.load(os.path.join(H5_FIXTURE, "arrays.npz"))
    root = os.path.join(tmp, "h5_fixture")
    shutil.copytree(H5_FIXTURE, root)
    files = sorted(n[:-3] for n in os.listdir(root) if n.endswith(".h5"))
    n_sets = 0
    for stem in files:
        got = list_datasets(os.path.join(root, f"{stem}.h5"))
        want = {k[len(stem) + 1:]: twin[k] for k in twin.files
                if k.startswith(stem + "/")}
        check(sorted(got) == sorted(want) and bool(want),
              f"fixture {stem}: datasets {sorted(got)} != {sorted(want)}")
        copy = os.path.join(root, "rewritten", f"{stem}.h5")
        for k, v in want.items():
            g = np.asarray(got[k])
            check(g.dtype == v.dtype and g.shape == v.shape
                  and g.tobytes() == v.tobytes(),
                  f"fixture {stem}/{k} differs from its twin")
            write_hdf5(copy, "/" + k, v)
        for k, v in want.items():
            g = np.asarray(read_hdf5(copy, "/" + k))
            check(g.dtype == v.dtype and g.tobytes() == v.tobytes(),
                  f"fixture {stem}/{k} rewritten by the port reads back "
                  f"different")
        n_sets += len(want)
    phase("recipe", f"h5py-written fixture: {len(files)} files, {n_sets} "
                    f"datasets read bit for bit against the .npz twin, and "
                    f"again after the port's write_hdf5 rewrote each file")
    feats = [os.path.join(root, f"{n}.h5") for n in H5_FIXTURE_FEATS]
    scp = os.path.join(root, "feats.scp")
    with open(scp, "w") as f:
        f.write("\n".join(feats) + "\n")
    stats = os.path.join(root, "stats.h5")
    gen = os.path.join(root, "gen", "feat_id.wav")
    argv = ["--feats", scp, "--stats", stats, "--config", conf, "--outdir",
            gen, "--checkpoint", ckpt, "--batch_size", "2", "--fs",
            str(FS), "--device", dev.type, "--verbose", "0"]
    (_, _, h, _, d), = qpnet_decode.decode_batches(
        feats, run_cfg, qpnet_decode.get_arguments(argv), load_scaler(stats))
    params = init_params(0, cfg, device=dev)
    err, maxd = path_shape_check(K, params, cfg, h,
                                 d[:, ::cfg.upsampling_factor], NS_K1_FRAMES,
                                 rng, dev, "h5_fixture k1")
    del params
    torch.cuda.synchronize()
    K.reset_launch_count()
    _, dec_s = _timed(lambda: qpnet_decode.main(argv))
    launches = K.launch_count
    check(launches > 0, "the fixture's decode must launch K1")
    lens = []
    for p in feats:
        stem = os.path.basename(p)[:-3]
        fs, x = wavfile.read(gen.replace("feat_id", stem))
        n_want = len(read_hdf5(p, "/f0")) * cfg.upsampling_factor - 1
        check(fs == FS and x.dtype == np.int16 and x.shape == (n_want,)
              and int(x.max()) > int(x.min()),
              f"fixture decode {stem}: {x.shape} (want {n_want})")
        lens.append(len(x))
    phase("recipe", f"qpnet_decode of the fixture's {len(feats)} feature "
                    f"files with its stats at B=2 (default net, random "
                    f"weights seed 0; K1 at its shape, maxd {maxd}: max "
                    f"|dlogit| to the f64 twin {err:.3e}): K1 launches "
                    f"{launches}, wavs of {lens} samples (F*up - 1), "
                    f"{dec_s:.3f} s; the leg's wall "
                    f"{time.perf_counter() - t_leg:.2f} s | {card}")
    return launches


def recipe_smoke(dev, card):
    """Phase 16: the recipe's workers (feature_extract on the host through
    the spawn pool and on the card, calc_stats, noise_shaping, the restore
    pass on the card, qpnet_decode through K1, noise_restored) on a
    synthetic corpus, then qpnet_serve's --noise_shaping filter on 3 TCP
    streams.  Returns K1's launches on the recipe's decode and on the
    noise-shaped serving runs, and W1-W4's on the device feature_extract."""
    import shutil
    import threading

    import torch
    from scipy.io import wavfile

    from qpnet_tpu_torch import serve as S
    from qpnet_tpu_torch.bin import (calc_stats, feature_extract,
                                     noise_restored, noise_shaping,
                                     qpnet_decode, qpnet_serve)
    from qpnet_tpu_torch.config import ModelConfig, RunConfig
    from qpnet_tpu_torch.data import load_scaler, read_hdf5, write_hdf5
    from qpnet_tpu_torch.data.hdf5_format import list_datasets
    from qpnet_tpu_torch.dsp import mlsa
    from qpnet_tpu_torch.dsp.emphasis import (StreamingEmphasizer,
                                              emphasis_coefs, emphasize,
                                              frame_count)
    from qpnet_tpu_torch.dsp.mcep import mc2b, mc2sp
    from qpnet_tpu_torch.dsp.world import WorldSynthesizer, gates
    from qpnet_tpu_torch.dsp.world import device_synthesis as DX
    from qpnet_tpu_torch.dsp.world.codec import decode_aperiodicity
    from qpnet_tpu_torch.dsp.world.synthesis import _pulse_times, synthesize
    from qpnet_tpu_torch.models.generate import (StreamingGenerator,
                                                 bucket_maxd)
    from qpnet_tpu_torch.models.qpnet import init_params
    from qpnet_tpu_torch.ops import decode_mu_law
    from qpnet_tpu_torch.ops import gen_kernel as K
    from qpnet_tpu_torch.ops import world_kernel as WK
    from qpnet_tpu_torch.tools.evaluate import wav_metrics
    from qpnet_tpu_torch.train.checkpoint import save_final
    t_phase = time.perf_counter()
    # the workers rename "wav" anywhere in a path, so the temp dir has none
    for _ in range(5):
        tmp = tempfile.mkdtemp(prefix="qp16_")
        if "wav" not in tmp:
            break
        os.rmdir(tmp)
    check("wav" not in tmp, f"temp dir {tmp} must not contain 'wav'")
    dv = dev.type
    try:
        rng = np.random.default_rng(16)
        host_root, dev_root = (os.path.join(tmp, n) for n in ("host", "dev"))
        os.makedirs(host_root)
        paths, lst = _recipe_corpus(host_root, rng)
        shutil.copytree(os.path.join(host_root, "wav"),
                        os.path.join(dev_root, "wav"))
        audio_s = float(sum(NS_SECONDS))
        ids = [os.path.splitext(os.path.basename(p))[0] for p in paths]
        common = ["--fs", str(FS), "--verbose", "0"]

        # extraction: host backends through 2 spawned workers; both device
        # backends on the card (the fused pass, pipelined at depth 2); the
        # device spectral stages with the host F0 in 2 threads (staged)
        _, host_s = _timed(lambda: feature_extract.main(
            ["--waveforms", lst, "--n_jobs", "2"] + common))
        torch.cuda.reset_peak_memory_stats()
        dev_args = ["--waveforms", os.path.join(dev_root, "wav"),
                    "--dsp_backend", "jax", "--f0_backend", "jax",
                    "--device", dv] + common
        feature_extract.main(dev_args + ["--feature_dir",
                                         os.path.join(tmp, "warm/")])
        torch.cuda.synchronize()
        WK.reset_launch_count()
        _, dev_s = _timed(lambda: feature_extract.main(dev_args))
        wk_fe = wk_counts()
        check(all(wk_fe[k] == len(paths) * n for k, n in WK_HARVEST.items()),
              f"device feature_extract of {len(paths)} utterances: W1-W4 "
              f"launches {wk_fe}")
        ext_mib = peak_mib(dev)
        staged = os.path.join(tmp, "staged/")
        feature_extract.main(
            ["--waveforms", os.path.join(dev_root, "wav"), "--dsp_backend",
             "jax", "--f0_backend", "host", "--n_jobs", "2", "--device", dv,
             "--feature_dir", staged] + common)
        feats = [os.path.join(host_root, "h5", f"{i}.h5") for i in ids]
        for i, utt in enumerate(ids):
            h = list_datasets(feats[i])
            d = list_datasets(os.path.join(dev_root, "h5", f"{utt}.h5"))
            s = list_datasets(os.path.join(staged, f"{utt}.h5"))
            schema = _schema(h)
            check(schema == _schema(d) == _schema(s),
                  f"{utt}: h5 schemas differ: {schema} {_schema(d)} "
                  f"{_schema(s)}")
            line = f0_gates(d["f0"], h["f0"], f"recipe {utt}")
            check(np.array_equal(s["f0"], h["f0"]),
                  f"{utt}: the staged path must keep the host F0")
            mc_h, mc_s = h["world"][:, 2:37], s["world"][:, 2:37]
            c0 = float(np.abs(mc_h[:, 0] - mc_s[:, 0]).mean())
            mc = float(np.abs(mc_h - mc_s).mean())
            cm = gates.codeap_full_metrics(h["world"][:, 37:],
                                           s["world"][:, 37:])
            same = (d["f0"] > 0) == (h["f0"] > 0)
            mc_f = float(np.abs(d["world"][same, 2:37]
                                - h["world"][same, 2:37]).mean())
            failed = gates.gate_failures(cm)
            check(c0 < gates.MCEP_C0_MAX and mc < gates.MCEP_MEAN_MAX
                  and mc_f < gates.MCEP_MEAN_MAX and not failed,
                  f"{utt}: device features {c0} {mc} {mc_f} {failed}")
            phase("recipe", f"{utt} ({len(h['f0'])} frames): h5 schema "
                            f"equal ({len(schema)} datasets); fused device "
                            f"F0 against the host: {line}; fused mcep mean "
                            f"|d| {mc_f:.2e} on frames of equal voicing; "
                            f"staged (host F0): mcep c0 mean |d| {c0:.2e}, "
                            f"mean |d| {mc:.2e}, codeap median "
                            f"{cm['codeap_median_db']:.2e} dB, "
                            f"{cm['codeap_n_over']} beyond "
                            f"{gates.CODEAP_MAX_DB} dB")
        phase("time", f"feature_extract of {len(paths)} utterances "
                      f"({audio_s:g} s of audio): host backends, 2 spawned "
                      f"workers, {host_s * 1e3 / audio_s:.3f} ms per second "
                      f"of audio (wall, spawning included); device backends "
                      f"(fused, depth 2, after a warm-up pass) "
                      f"{dev_s * 1e3 / audio_s:.3f} ms/s, W1-W4 launches "
                      f"{wk_fe}; peak device memory {ext_mib:.1f} MiB | "
                      f"{card}")

        # stats: the streaming scaler against one float64 batch
        feats_scp = os.path.join(tmp, "feats.scp")
        with open(feats_scp, "w") as f:
            f.write("\n".join(feats) + "\n")
        stats = os.path.join(tmp, "stats.h5")
        calc_stats.main(["--features", feats_scp, "--stats", stats,
                         "--verbose", "0"])
        allf = np.concatenate([read_hdf5(p, "/world") for p in feats]
                              ).astype(np.float64)
        want_m, want_s = allf.mean(0), allf.std(0)
        want_m[0], want_s[0] = 0.0, 1.0
        want_s[want_s == 0.0] = 1.0
        got_m = read_hdf5(stats, "/world/mean")
        got_s = read_hdf5(stats, "/world/scale")
        dm = float(np.abs(got_m - want_m).max() / np.abs(want_m).max())
        ds = float(np.abs(got_s - want_s).max() / np.abs(want_s).max())
        check(dm <= 1e-12 and ds <= 1e-12, f"stats {dm} {ds}")
        phase("recipe", f"calc_stats over {allf.shape[0]} frames: mean and "
                        f"scale against one float64 batch, max |d| / max "
                        f"|ref| {dm:.2e} and {ds:.2e} (max 1e-12)")

        # shaping: the files equal emphasize of their wavs; the first 0.25 s
        # through the C++ core and the plain per-sample loop
        _, ns_s = _timed(lambda: noise_shaping.main(
            ["--waveforms", lst, "--stats", stats, "--n_jobs", "1"]
            + common))
        coefs = emphasis_coefs(stats, "world", 2, 37, 0.5, invert=True)
        for p in paths:
            x = wavfile.read(p)[1].astype(np.float64)
            want = np.clip(emphasize(x, FS, coefs, 0.455, 5.0), -32768,
                           32767).astype(np.int16)
            got = wavfile.read(p.replace("wav", "wav_h5_ns").replace(
                ".wav_h5_ns", ".wav"))[1]
            check(np.array_equal(got, want), f"{p}: shaped file")
        x = wavfile.read(paths[0])[1][: int(0.25 * FS)].astype(np.float64)
        b = mc2b(np.tile(coefs, (frame_count(len(x), FS, 5.0), 1)), 0.455)
        hop = int(FS * 5.0 / 1000)
        y_core = mlsa.mlsa_filter(x, b, 0.455, hop)
        y_plain, _ = mlsa.mlsa_filter_plain(x, b, 0.455, hop)
        d_core = float(np.abs(y_core - y_plain).max() / np.abs(y_plain).max())
        check(d_core <= 1e-12, f"MLSA core against the plain loop {d_core}")
        phase("recipe", f"noise_shaping: {len(paths)} files equal emphasize "
                        f"of their wavs; MLSA of {len(x)} samples, C++ core "
                        f"against the plain loop max |d| / max |ref| "
                        f"{d_core:.2e} (max 1e-12, before int16 rounding)")
        phase("time", f"noise_shaping {ns_s * 1e3 / audio_s:.3f} ms per "
                      f"second of audio (one worker, CLI wall) | {card}")

        # the restore pass on the card: one utterance queued without a sync;
        # pulse times, the ap = 0 waveform, MCD on the JAX test's inputs
        f0 = read_hdf5(feats[0], "/f0")
        w = read_hdf5(feats[0], "/world").astype(np.float64)
        syn = WorldSynthesizer(fs=FS, backend="jax", device=dev)
        syn.synthesis_fetch(syn.restore_async(f0, w[:, 2:37], w[:, 37:],
                                              0.455))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            handle = syn.restore_async(f0, w[:, 2:37], w[:, 37:], 0.455)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        y_dev = syn.synthesis_fetch(handle)
        check(np.isfinite(y_dev).all() and y_dev.std() > 1.0,
              "device restore output")
        ta = np.arange(len(f0)) * 0.005
        n = int(len(f0) * 0.005 * FS)
        idx_h, sh_h, v_h = _pulse_times(f0, ta, FS, n)
        idx_d, sh_d, v_d = DX.pulse_times_debug(f0, FS, 5.0, device=dev)
        # a pulse's time is its index plus its fractional shift: where the
        # phase lands on a whole cycle, one side may take the next index
        # with a shift of 0 for the other's shift of one sample
        same_n = len(idx_h) == len(idx_d)
        dt = (float(np.abs(idx_h + sh_h * FS - idx_d - sh_d * FS).max())
              if same_n else float("inf"))
        check(same_n and dt < 1e-6 and np.array_equal(v_h, v_d),
              f"device pulse times must equal the host's: {len(idx_h)} "
              f"and {len(idx_d)} pulses, max |dt| {dt} samples")
        # ap = 0 on the voiced (continuous) F0: deterministic throughout
        sp = mc2sp(w[:, 2:37], 0.455, 1024)
        ap0 = np.full_like(sp, 1e-6)
        pm = gates.periodic_metrics(
            synthesize(w[:, 1], sp, ap0, FS),
            DX.device_synthesize(w[:, 1], sp, ap0, 0, FS, device=dev).cpu())
        rf = gates.restore_features(120, FS)
        fix = os.path.join(tmp, "fix")
        outs = {}
        for backend in ("numpy", "jax"):
            root = os.path.join(fix, backend)
            os.makedirs(os.path.join(root, "wav"))
            wavfile.write(os.path.join(root, "wav", "u1.wav"), FS,
                          np.zeros(int(120 * 0.005 * FS), np.int16))
            for k, v in rf.items():
                write_hdf5(os.path.join(root, "h5", "u1.h5"), k, v)
            feature_extract.main(["--waveforms", os.path.join(root, "wav"),
                                  "--inv", "false", "--dsp_backend", backend,
                                  "--device", dv] + common)
            outs[backend] = wavfile.read(os.path.join(
                root, "h5_restored", "u1.wav"))[1].astype(np.float64)
        kw = dict(minf0=60, maxf0=400)
        floor = gates.restore_floor(rf["/world"], rf["/f0"], FS, **kw)
        mm = wav_metrics(outs["numpy"], outs["jax"], FS, **kw)
        failed = gates.gate_failures(pm)
        check(not failed and mm["mcd_db"] <= floor["mcd_db"]
              + gates.RESTORE_MCD_MARGIN_DB
              and mm["f0_rmse_hz"] < gates.RESTORE_F0_RMSE_HZ,
              f"restore gates {failed} {mm} {floor}")
        phase("recipe", f"restore on the card: {ids[0]} queued with no "
                        f"sync; pulse times equal to the host's "
                        f"({len(idx_h)} pulses, voicing equal, times within "
                        f"{dt:.1e} sample (max 1e-6), "
                        f"{int((idx_h != idx_d).sum())} on a whole cycle "
                        f"indexed one sample later); "
                        f"ap = 0 waveform against the host: correlation "
                        f"{pm['syn_corr']:.6f} (min "
                        f"{gates.PERIODIC_CORR_MIN}), rms |d| / rms "
                        f"{pm['syn_rel_rms']:.2e} (max "
                        f"{gates.PERIODIC_RMS_MAX}); the JAX test's restore "
                        f"inputs through the CLI: MCD {mm['mcd_db']:.4f} dB "
                        f"(max floor {floor['mcd_db']:.4f} + "
                        f"{gates.RESTORE_MCD_MARGIN_DB}), F0 RMSE "
                        f"{mm['f0_rmse_hz']:.4f} Hz (max "
                        f"{gates.RESTORE_F0_RMSE_HZ})")
        rest = {}
        for backend in ("numpy", "jax"):
            root = os.path.join(tmp, f"rest_{backend}")
            shutil.copytree(os.path.join(host_root, "wav"),
                            os.path.join(root, "wav"))
            shutil.copytree(os.path.join(host_root, "h5"),
                            os.path.join(root, "h5"))
            _, rest[backend] = _timed(lambda: feature_extract.main(
                ["--waveforms", os.path.join(root, "wav"), "--inv", "false",
                 "--dsp_backend", backend, "--n_jobs", "1", "--device",
                 dv] + common))
        m = wav_metrics(*(wavfile.read(os.path.join(
            tmp, f"rest_{b}", "h5_restored", f"{ids[0]}.wav"))[1]
            .astype(np.float64) for b in ("numpy", "jax")), FS)
        check(m["f0_rmse_hz"] < gates.RESTORE_F0_RMSE_HZ,
              f"corpus restore F0 {m}")
        synth_ms = median_ms(lambda: syn.synthesis_fetch(syn.restore_async(
            f0, w[:, 2:37], w[:, 37:], 0.455)))
        sp_full = mc2sp(w[:, 2:37], 0.455, 1024)
        ap_full = decode_aperiodicity(w[:, 37:], FS, 1024)
        _, host_syn_s = _timed(lambda: synthesize(f0, sp_full, ap_full, FS))
        secs0 = NS_SECONDS[0]
        phase("time", f"restore pass of {audio_s:g} s: host "
                      f"{rest['numpy'] * 1e3 / audio_s:.3f} ms per second of "
                      f"audio, device {rest['jax'] * 1e3 / audio_s:.3f} "
                      f"ms/s (CLI walls; corpus F0 RMSE device against host "
                      f"{m['f0_rmse_hz']:.4f} Hz); synthesis of {ids[0]} "
                      f"alone: host {host_syn_s * 1e3 / secs0:.3f} ms/s, "
                      f"device restore {synth_ms[0] / secs0:.3f} "
                      f"({synth_ms[1] / secs0:.3f}-{synth_ms[2] / secs0:.3f})"
                      f" ms/s (median of 5, CUDA events) | {card}")

        # decode the extracted features through K1, then noise_restored
        cfg = ModelConfig()
        up = cfg.upsampling_factor
        conf = os.path.join(tmp, "exp", "model.conf")
        run_cfg = RunConfig(model=cfg, fs=FS)
        run_cfg.save(conf)
        params = init_params(0, cfg, device=dev)
        ckpt = save_final(os.path.join(tmp, "exp"), params)
        gen = os.path.join(tmp, "gen", "feat_id.wav")
        dec_argv = ["--feats", feats_scp, "--stats", stats, "--config", conf,
                    "--outdir", gen, "--checkpoint", ckpt, "--batch_size",
                    "4", "--fs", str(FS), "--device", dv, "--verbose", "0"]
        # K1 at the decode's shape: its one batch as decode_batches builds it
        (_, _, h_dec, _, d_dec), = qpnet_decode.decode_batches(
            feats, run_cfg, qpnet_decode.get_arguments(dec_argv),
            load_scaler(stats))
        dec_err, dec_maxd = path_shape_check(
            K, params, cfg, h_dec, d_dec[:, ::up], NS_K1_FRAMES, rng, dev,
            "recipe k1")
        del params      # the decode loads its own, and its peak is its own
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_count()
        _, dec_s = _timed(lambda: qpnet_decode.main(dec_argv))
        recipe_launches = K.launch_count
        check(recipe_launches > 0, "qpnet_decode must launch K1")
        dec_mib = peak_mib(dev)
        res = os.path.join(tmp, "res", "feat_id.wav")
        noise_restored.main(
            ["--feats", feats_scp, "--stats", stats, "--outdir", gen,
             "--writedir", res, "--fs", str(FS), "--mcep_dim_end", "37",
             "--mcep_alpha", "0.455", "--n_jobs", "1", "--verbose", "0"])
        coefs_r = emphasis_coefs(stats, "world", 2, 37, 0.5, invert=False)
        for i, utt in enumerate(ids):
            g = wavfile.read(gen.replace("feat_id", utt))[1]
            r = wavfile.read(res.replace("feat_id", utt))[1]
            n_want = len(read_hdf5(feats[i], "/f0")) * up - 1
            want = np.clip(emphasize(g.astype(np.float64), FS, coefs_r,
                                     0.455, 5.0), -32768, 32767
                           ).astype(np.int16)
            check(g.shape == (n_want,) and int(g.max()) > int(g.min())
                  and np.array_equal(r, want),
                  f"{utt}: decoded {g.shape} (want {n_want}) or restored")
        phase("recipe", f"qpnet_decode of the {len(ids)} extracted feature "
                        f"files at B=4 (default net, random weights seed 0, "
                        f"sampling; K1 at its shape, maxd {dec_maxd}: max "
                        f"|dlogit| to the f64 twin {dec_err:.3e}): K1 "
                        f"launches {recipe_launches}, "
                        f"{dec_s:.3f} s, peak device memory {dec_mib:.1f} "
                        f"MiB; noise_restored: each file equal to emphasize "
                        f"of the decoded wav | {card}")

        # the port's HDF5 on the recipe's files, then the h5py-written
        # fixture: read, rewritten, decoded through K1
        h5_line = h5_times(feats, tmp)
        phase("time", f"HDF5 through the port's reader and writer "
                      f"(data/hdf5_format.py) on the {len(feats)} extracted "
                      f"feature files: {h5_line} | {card}")
        fixture_launches = h5_fixture_leg(dev, card, tmp, conf, ckpt,
                                          run_cfg, rng)

        # serving with --noise_shaping: the factory and frontend of the
        # serve CLI's own code, 3 TCP streams of NS_FRAMES frames
        argv = ["--config", conf, "--stats", stats, "--checkpoint", ckpt,
                "--fs", str(FS), "--noise_shaping", "--mcep_dim_end", "37",
                "--mcep_alpha", "0.455"]
        args = qpnet_serve.get_arguments(argv)
        factory = qpnet_serve.make_postfilter_factory(args, "world")
        frontend = qpnet_serve.make_frontend(load_scaler(stats), args, cfg)
        raw = [read_hdf5(p, "/world")[:NS_FRAMES].astype(np.float32)
               for p in feats[:NS_STREAMS]]
        hd = [frontend(r) for r in raw]
        maxd = bucket_maxd(float(max(d.max() for _, d in hd)))
        params = init_params(0, cfg, device=dev)
        B = 1 << (NS_STREAMS - 1).bit_length()
        # the session's inputs, idle rows as the direct session below has
        h = np.zeros((B, NS_FRAMES, cfg.n_aux), np.float32)
        d = np.ones((B, NS_FRAMES), np.float32)
        for i, (hi, di) in enumerate(hd):
            h[i], d[i] = hi, di
        ns_err, ns_maxd = path_shape_check(K, params, cfg, h, d, NS_K1_FRAMES,
                                           rng, dev, "serve_ns k1")
        check(ns_maxd == maxd, f"serving check's maxd {ns_maxd} != {maxd}")

        def serve(mode, post, **gather):
            K.reset_launch_count()
            svc = S.StreamingService(
                params, cfg, max_streams=NS_STREAMS, maxd=maxd, mode=mode,
                min_chunk_samples=NS_CHUNK, first_chunk_samples=1100,
                frontend=frontend, devices=[dev],
                postfilter_factory=factory if post else None, **gather)
            svc.prewarm([NS_STREAMS])
            srv = S.serve_tcp(svc, port=0)
            results, errors = [None] * NS_STREAMS, []

            def client(i):
                try:
                    t0 = time.perf_counter()
                    first, chunks = None, []
                    for c in S.request_stream(srv.server_address, raw[i]):
                        if first is None:
                            first = time.perf_counter() - t0
                        chunks.append(c)
                    results[i] = (np.concatenate(chunks), first,
                                  time.perf_counter() - t0)
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(f"stream {i}: {e!r}")

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(NS_STREAMS)]
            try:
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
            finally:
                srv.shutdown()
                srv.server_close()
                svc.close()
            check(not errors and all(not t.is_alive() for t in threads),
                  f"{mode} streams: {errors}")
            return results, dict(svc.stats), K.launch_count

        torch.cuda.reset_peak_memory_stats()
        res_a, st, serve_launches = serve("argmax", True,
                                          gather_window_s=60.0,
                                          gather_quiet_s=30.0)
        check(st["groups"] == 1, f"the streams must form one group: {st}")
        direct = StreamingGenerator(params, cfg, B, maxd=maxd, mode="argmax",
                                    device=dev).feed(h, d)
        equal = 0
        for i, (got, _, _) in enumerate(res_a):
            want = np.clip(emphasize(decode_mu_law(
                direct[i, :NS_FRAMES * up], cfg.n_quantize), FS, coefs_r,
                0.455, 5.0) * 32768, -32768, 32767).astype(np.int16)
            equal += int(got.dtype == np.int16 and np.array_equal(got, want))
        check(equal == NS_STREAMS, "served --noise_shaping PCM must equal a "
                                   "direct session through emphasize")
        line = []
        for post in (True, False):
            res_s, st, n = serve("sampling", post, gather_window_s=0.25)
            if post:
                serve_launches += n
            for pcm, _, _ in res_s:
                check(pcm.shape == (NS_FRAMES * up,)
                      and int(pcm.max()) > int(pcm.min()),
                      "sampled streams must be non-constant PCM")
            ttfa = [r[1] for r in res_s]
            rtf = [NS_FRAMES * up / FS / r[2] for r in res_s]
            line.append(f"{'with' if post else 'without'} the filter: "
                        f"time to first audio median "
                        f"{float(np.median(ttfa)):.4f} s "
                        f"{[round(t, 4) for t in ttfa]}, realtime factor "
                        f"median {float(np.median(rtf)):.4f}")
        check(serve_launches > 0, "the --noise_shaping path must launch K1")
        phase("serve", f"--noise_shaping, default net bf16, {NS_STREAMS} "
                       f"TCP streams of {NS_FRAMES} frames (session B={B}, "
                       f"maxd {maxd}; K1 at its shape: max |dlogit| to the "
                       f"f64 twin {ns_err:.3e}): argmax PCM equal to a direct "
                       f"StreamingGenerator through one-shot emphasize "
                       f"{equal}/{NS_STREAMS}; sampling " + "; ".join(line)
                       + f"; K1 launches {serve_launches}; peak device "
                       f"memory {peak_mib(dev):.1f} MiB | {card}")

        # the filter's host time per chunk beside K1's for the same chunk
        filt = factory()
        chunk = decode_mu_law(direct[0, :NS_CHUNK], cfg.n_quantize)
        emph = []
        for _ in range(11):
            t0 = time.perf_counter()
            filt.process(chunk)
            emph.append((time.perf_counter() - t0) * 1e3)
        frames = NS_CHUNK // up
        sess = StreamingGenerator(params, cfg, B, maxd=maxd, mode="argmax",
                                  device=dev)
        sess.feed(h[:, :frames], d[:, :frames])
        k1 = median_ms(lambda: sess.feed(h[:, :frames], d[:, :frames]))
        phase("time", f"StreamingEmphasizer.process of a {NS_CHUNK}-sample "
                      f"chunk (handler thread, host): median "
                      f"{float(np.median(emph)):.3f} ms ({min(emph):.3f}-"
                      f"{max(emph):.3f}, 11 chunks); K1's feed of the same "
                      f"chunk at B={B}: {k1[0]:.3f} ({k1[1]:.3f}-{k1[2]:.3f})"
                      f" ms | {card}")
        del params, sess, direct
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase("recipe", f"phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return recipe_launches, serve_launches, fixture_launches, wk_fe


# --- phase 17: the synthetic recipe on the card -----------------------------

SR_SPK = "SYN1"
SR_SECONDS = "1.5"     # make_synth_corpus --seconds (its default is 3.0)
SR_ITERS = "100"       # SI iterations (the recipe's 200,000)
SR_UITERS = "100"      # SD iterations (the recipe's 3,000)
SR_F0FACTOR = "1.5"
# host worker processes (the defaults: 20 and 25): runFE spawns 2 (the
# histograms' analysis, the shaping), runQP's restoration runs inline
SR_FE_JOBS, SR_QP_JOBS = ["--n_jobs", "2"], ["--n_jobs", "1"]


def synth_recipe_smoke(dev, card):
    """Phase 17: run_synth.sh's stages c f t a d s e in process, with the
    argv the port's script gives (device analysis), runFE -1 first, on the
    default network at full width; returns K1's launches on its decodes
    and W1-W4's on its feature extraction (runFE -1 to -4)."""
    import contextlib
    import io
    import shutil

    import torch
    from scipy.io import wavfile

    from qpnet_tpu_torch import runFE, runQP
    from qpnet_tpu_torch.bin import qpnet_decode
    from qpnet_tpu_torch.config import RunConfig
    from qpnet_tpu_torch.data import load_scaler, read_hdf5, read_txt
    from qpnet_tpu_torch.models.qpnet import init_params
    from qpnet_tpu_torch.ops import gen_kernel as K
    from qpnet_tpu_torch.ops import train_kernel as TK
    from qpnet_tpu_torch.ops import world_kernel as WK
    from qpnet_tpu_torch.tools import evaluate, make_synth_corpus
    from qpnet_tpu_torch.utils.yamlconf import (read_loss_record,
                                                read_validation_record)
    t_phase = time.perf_counter()
    # the recipe renames "wav" anywhere in a path, so the project has none
    for _ in range(5):
        prj = tempfile.mkdtemp(prefix="qp17_")
        if "wav" not in prj:
            break
        os.rmdir(prj)
    check("wav" not in prj, f"project dir {prj} must not contain 'wav'")
    dv, spk = dev.type, SR_SPK
    prev_prj = os.environ.get("QPNET_PRJ_DIR")
    os.environ["QPNET_PRJ_DIR"] = prj      # as run_synth.sh exports it
    corpus = os.path.join(prj, "corpus", "SYNTH")
    fe = ["--device", dv, "-f", str(FS), "--corpus", "SYNTH",
          "--dsp_backend", "jax", "--f0_backend", "jax"] + SR_FE_JOBS
    qp = ["--device", dv, "-w", "synthtr.scp", "-a", "synthtr.scp", "-f",
          str(FS), "-d", "8", "--corpus", "SYNTH", "--dtype",
          "bfloat16"] + SR_QP_JOBS
    sd = ["-x", f"synthup_{spk}.scp", "-u", f"synthup_{spk}.scp"]
    model = "Asynthtr_Wsynthtr_d8"
    sd_model = f"{model}_Usynthup_{spk}_Vsynthup_{spk}"
    walls, peaks, launches = {}, {}, {}

    def stage(name, fn, exits=False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            fn()
            check(not exits, f"{name} must end with sys.exit(0)")
        except SystemExit as e:       # runFE -1 ends so
            check(exits and e.code == 0, f"{name} exited with {e.code}")
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        peaks[name] = peak_mib(dev)

    def decode(name, argv):
        K.reset_launch_count()
        stage(name, lambda: runQP.main(qp + argv))
        launches[name] = K.launch_count
        check(launches[name] > 0, f"{name}: the decode must launch K1")

    try:
        # c: the corpus; runFE -1 (histograms, conf); f: features, stats,
        # noise shaping
        stage("c corpus", lambda: make_synth_corpus.main(
            ["--corpus_dir", corpus, "--fs", str(FS), "--speakers", "1",
             "--train_utts", "6", "--seconds", SR_SECONDS, "--seed", "0"]))
        audio = {k: sum(len(wavfile.read(os.path.join(corpus, ln[9:]))[1])
                        for ln in read_txt(os.path.join(corpus, "scp",
                                                        f"{k}.scp"))) / FS
                 for k in ("synthtr", "syntheval")}
        WK.reset_launch_count()
        stage("runFE -1", lambda: runFE.main(
            fe + ["-e", f"synthtr_{spk}.scp", "-1", spk]), exits=True)
        for set_ in ("synthtr", "syntheval"):
            stage(f"runFE -2 {set_}", lambda set_=set_: runFE.main(
                fe + ["-r", "-i", "-e", f"{set_}_{spk}.scp", "-2", spk]))
        stage("runFE -3", lambda: runFE.main(
            fe + ["-r", "-e", "synthtr.scp", "-3", "allspk"]))
        stage("runFE -4", lambda: runFE.main(
            fe + ["-r", "-e", "synthtr.scp", "-4", "allspk"]))
        for png in ("f0", "npow"):
            check(os.path.getsize(os.path.join(
                corpus, "hist", f"{spk}_{png}histogram.png")) > 0,
                f"runFE -1: the {png} histogram")
        wk_fe = wk_counts()
        check(all(wk_fe[k] > 0 for k in ("pool", "viterbi", "smooth")),
              f"runFE's device analysis: W1-W4 launches {wk_fe}")

        # t: SI training on the plain engine (runQP passes no
        # --fixed_engine, so auto resolves to it: K2 is not launched)
        TK.reset_launch_counts()
        stage("runQP -1", lambda: runQP.main(qp + ["-I", SR_ITERS, "-1"]))
        check(TK.fwd_launch_count == TK.bwd_launch_count == 0,
              "runQP's training must take the plain engine")
        # a: SD adaptation, the sweep, K1 at the decode's shape, the SD
        # decode at the sweep's best iteration
        stage("runQP -2", lambda: runQP.main(qp + sd + ["-U", SR_UITERS,
                                                        "-2"]))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            stage("runQP -5", lambda: runQP.main(
                qp + sd + ["-y", f"synthva_{spk}.scp", "-v",
                           f"synthva_{spk}.scp", "-U", SR_UITERS, "-5"]))
        print(out.getvalue(), end="", flush=True)
        models = os.path.join(prj, "qpnet_models")
        res = read_validation_record(os.path.join(models, sd_model,
                                                  "validation_result.yml"))
        best = min(res, key=res.get).split("-")[-1].split(".")[0]
        check(best == SR_UITERS and f"best iteration: {best} (loss "
              in out.getvalue(), f"best iteration {best}: {out.getvalue()}")
        check(sorted(res) == [f"checkpoint-{SR_UITERS}.pkl"]
              and all(np.isfinite(v) for v in res.values()),
              f"validation_result.yml {res}")

        feats = sorted(os.path.join(corpus, ln[9:]).replace(
            "wav", "h5") for ln in read_txt(os.path.join(
                corpus, "scp", f"syntheval_{spk}.scp")))
        stats = os.path.join(corpus, "stats", "synthtr_stats.h5")
        conf = os.path.join(models, sd_model, "model.conf")
        run_cfg = RunConfig.load(conf)
        cfg = run_cfg.model
        args = qpnet_decode.get_arguments(
            ["--feats", "-", "--stats", stats, "--config", conf, "--outdir",
             "-", "--checkpoint", "-", "--fs", str(FS), "--batch_size",
             str(runQP.DECODE_BATCH_SIZE)])
        (_, _, h_dec, _, d_dec), = qpnet_decode.decode_batches(
            feats, run_cfg, args, load_scaler(stats))
        # random weights (seed 0), as the gate's other checks have them
        params = init_params(0, cfg, device=dev)
        k1_err, k1_maxd = path_shape_check(
            K, params, cfg, h_dec, d_dec[:, ::cfg.upsampling_factor],
            NS_K1_FRAMES, np.random.default_rng(17), dev, "run_synth k1")
        del params
        ev = ["-e", f"syntheval_{spk}.scp"]
        decode("a SD decode", ["-r"] + sd + ev + ["-M", best, "-3", "-4",
                                                  spk])
        # d, s: the SI model, then its F0-scaled decode
        decode("d SI decode", ["-m", "-r"] + ev + ["-M", "final", "-3", "-4",
                                                   spk])
        decode("s F0 x1.5", ["-m", "-r"] + ev + ["-M", "final", "-F",
                                                 SR_F0FACTOR, "-3", "-4",
                                                 spk])

        # the layout the CPU tests fix, and finite losses
        want = {model: {"checkpoint-final.pkl", "model.conf",
                        "loss-final.yml"},
                sd_model: {f"checkpoint-{SR_UITERS}.pkl",
                           "checkpoint-final.pkl", "model.conf",
                           "loss-final.yml", "validation_result.yml"}}
        losses = {}
        for m, names in want.items():
            have = set(os.listdir(os.path.join(models, m)))
            check(names <= have, f"{m}: {sorted(names - have)} missing")
            losses[m] = read_loss_record(os.path.join(models, m,
                                                      "loss-final.yml"))
            check(len(losses[m]) > 0 and np.isfinite(losses[m]).all(),
                  f"{m}: losses {losses[m]}")
        up = cfg.upsampling_factor
        n_wavs = 0
        for m, it, suffixes in ((sd_model, best, ("",)),
                                (model, "final", ("", f"_{SR_F0FACTOR}"))):
            for mode in ("noiseshaped", "restored"):
                d = os.path.join(prj, "qpnet_output", m, mode, spk, it)
                for f in feats:
                    utt = os.path.splitext(os.path.basename(f))[0]
                    for sfx in suffixes:
                        x = wavfile.read(os.path.join(d,
                                                      f"{utt}{sfx}.wav"))[1]
                        n_want = read_hdf5(f, "/world").shape[0] * up - 1
                        check(x.dtype == np.int16 and x.shape == (n_want,)
                              and int(x.max()) > int(x.min()),
                              f"{d}/{utt}{sfx}.wav: {x.dtype} {x.shape}, "
                              f"want {n_want} samples")
                        n_wavs += 1

        # e: the restored wavs against the source wavs
        src = os.path.join(corpus, "wav", "synth_evaluation", spk)
        scores = {}
        for name, m, it in (("SI", model, "final"), ("SD", sd_model, best)):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                stage(f"e evaluate {name}", lambda m=m, it=it: evaluate.main(
                    ["--ref_wavs", src, "--gen_wavs", os.path.join(
                        prj, "qpnet_output", m, "restored", spk, it)]))
            scores[name] = json.loads(out.getvalue().strip().splitlines()[-1])
            check(scores[name]["n_utterances"] == len(feats),
                  f"evaluate {name}: {scores[name]}")
    finally:
        shutil.rmtree(prj, ignore_errors=True)
        if prev_prj is None:
            os.environ.pop("QPNET_PRJ_DIR", None)
        else:
            os.environ["QPNET_PRJ_DIR"] = prev_prj

    n_k1 = sum(launches.values())
    phase("run_synth", f"corpus {audio['synthtr']:.3f} s of training and "
                       f"{audio['syntheval']:.3f} s of evaluation audio "
                       f"(1 speaker, seed 0); SI {SR_ITERS} and SD "
                       f"{SR_UITERS} iterations, default net (R="
                       f"{cfg.n_resch}, S={cfg.n_skipch}, "
                       f"{len(cfg.dilationsF) + len(cfg.dilationsA)} "
                       f"layers), bf16, plain engine (K2 launched 0 times); "
                       f"best iteration {best}; losses finite (SI "
                       f"last {losses[model][-1]:.4f}, SD last "
                       f"{losses[sd_model][-1]:.4f}, validation "
                       f"{res['checkpoint-' + best + '.pkl']:.4f}); K1 at "
                       f"the decode's shape (B={h_dec.shape[0]}, maxd "
                       f"{k1_maxd}): max |dlogit| to the f64 twin "
                       f"{k1_err:.3e}; K1 launches by decode {launches}; "
                       f"W1-W4 launches in runFE {wk_fe}; "
                       f"{n_wavs} wavs of F*up - 1 samples in the recipe's "
                       f"layout")
    for name, sc in scores.items():
        phase("run_synth", f"evaluate {name} restored against the source "
                           f"wavs: {json.dumps(sc)}")
    phase("time", "run_synth stages, wall s (peak device MiB): " + ", ".join(
        f"{k} {walls[k]:.3f} ({peaks[k]:.1f})" for k in walls)
        + f"; SI training {walls['runQP -1'] * 1e3 / int(SR_ITERS):.3f} ms "
        f"per iteration (CLI wall over {SR_ITERS} iterations, start-up and "
        f"h5 reads included) | {card}")
    phase("run_synth", f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return n_k1, wk_fe



# --- phase 18: data parallelism on one card -------------------------------

DP_SHARDS = 2
DP_ITERS = 4
DP_WORKER = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
from qpnet_tpu_torch.bin import qpnet_train
from qpnet_tpu_torch.ops import train_kernel as TK
t0 = time.perf_counter()
qpnet_train.main({argv!r})
torch.cuda.synchronize()
print("dp rank " + json.dumps({{
    "wall": time.perf_counter() - t0, "fwd": TK.fwd_launch_count,
    "bwd": TK.bwd_launch_count,
    "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}}), flush=True)
"""


def _dp_corpus(root, cfg):
    """4 utterances of 2-3 s as int16 wavs and h5 features (phase 7's
    in-memory corpus, seed 18), their lists and stats."""
    from scipy.io import wavfile

    from qpnet_tpu_torch.data import calc_stats, write_hdf5
    utts, _ = memory_corpus(cfg, seed=18, n_utts=4)
    wavs, feats = [], []
    for i, (fs, x, h) in enumerate(utts):
        wavs.append(os.path.join(root, f"utt{i}.wav"))
        feats.append(os.path.join(root, f"utt{i}.h5"))
        wavfile.write(wavs[-1], fs,
                      np.clip(x * 32767, -32768, 32767).astype(np.int16))
        write_hdf5(feats[-1], "/world", h.astype(np.float32))
    lists = []
    for name, paths in (("wav.scp", wavs), ("feat.scp", feats)):
        lists.append(os.path.join(root, name))
        with open(lists[-1], "w") as f:
            f.write("\n".join(paths) + "\n")
    stats = os.path.join(root, "stats.h5")
    calc_stats(feats, stats)
    return lists[0], lists[1], stats


def _dp_hosts(pairs, timeout=300):
    """Pairs of `qpnet_train` processes, each pair joined as hosts 0 and 1
    at a free local coordinator of its own, all started together, so that
    the pairs' start-ups overlap.  `pairs` is [(argv, env_for)]; returns
    [(outputs, wall)] in that order, a pair's wall from the common start to
    its last exit.  A process that fails or outlives the timeout fails the
    phase; each is killed in a finally."""
    import socket
    import subprocess
    root = os.path.dirname(os.path.abspath(__file__))
    base = {k: v for k, v in os.environ.items()
            if k not in ("QPNET_PREEMPT_AFTER", "QPNET_COORDINATOR",
                         "QPNET_NUM_HOSTS", "QPNET_HOST_ID")}
    procs = []
    t0 = time.perf_counter()

    def finish(p):
        out = p.communicate(timeout=timeout)[0]
        return out, time.perf_counter() - t0
    try:
        for argv, env_for in pairs:
            with socket.socket() as sk:
                sk.bind(("127.0.0.1", 0))
                coord = f"127.0.0.1:{sk.getsockname()[1]}"
            for hid in range(2):
                a = argv + ["--coordinator", coord, "--n_hosts", "2",
                            "--host_id", str(hid)]
                a[a.index("--config") + 1] += f".{hid}"
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", DP_WORKER.format(root=root, argv=a)],
                    env=dict(base, **env_for(hid)), stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
        with ThreadPoolExecutor(len(procs)) as ex:
            done = list(ex.map(finish, procs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, (out, _)) in enumerate(zip(procs, done)):
        check(p.returncode == 0, f"dp pair {i // 2} host {i % 2} exited "
                                 f"{p.returncode}:\n{out[-3000:]}")
    return [([done[i][0], done[i + 1][0]], max(done[i][1], done[i + 1][1]))
            for i in range(0, len(done), 2)]


def _rank_line(out):
    import re
    m = re.search(r"^dp rank (\{.*\})$", out, re.M)
    check(m is not None, "a dp rank printed no record")
    return json.loads(m.group(1))


def dp_smoke(dev, card, case4, step_ms):
    """Phase 18: sharded decode through K1 and two-rank dp training through
    K2 on the one card; returns K1's and K1-w8a8's launches on the sharded
    decodes and the ranks' (forward, backward) K2 launches."""
    t_phase = time.perf_counter()
    k1, w8 = dp_decode_smoke(dev, card, case4)
    k2 = dp_train_smoke(card, step_ms)
    phase("dp", f"phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return {"k1": k1, "w8a8": w8, "k2": k2}


def offset_check(K, params, cfg, h, d, per, dev, quantize="none"):
    """K1 on the last rows of a batch as the sharded decode runs them:
    primed from the whole batch (as each shard primes), B - per rows at
    b_offset = per, over the first frame at the maxd bucket of all of d.
    Held against its twin (`sample_check`: bit for bit in w8a8) and, in
    sampling mode, against those rows of one call over the whole batch."""
    import torch

    from qpnet_tpu_torch.models import generate as G
    B, up, Q = h.shape[0], cfg.upsampling_factor, cfg.n_quantize
    maxd = G.bucket_maxd(float(np.nanmax(np.ceil(d))))
    x_seed = torch.full((B, cfg.receptive_field(maxd) + 1), Q // 2,
                        dtype=torch.int64, device=dev)
    h_pad, d_fr, _ = G._pallas_host_prep(cfg, h[:, :1], d[:, :up], up, dev)
    packed, bufF0, bufA0, x0 = G._prologue(params, cfg, x_seed, h_pad[0],
                                           maxd, const_seed=True,
                                           quantize=quantize)
    kw = dict(maxd=maxd, n_steps=up, quantize=quantize)
    whole = K.generate(packed, cfg, bufF0, bufA0, x0, h_pad[:1], d_fr[:1], 7,
                       B=B, **kw, mode="sampling")
    shard = (packed, cfg, bufF0[:, per:].contiguous(),
             bufA0[:, per:].contiguous(), x0[:, per:].contiguous(),
             h_pad[:1, per:].contiguous(), d_fr[:1, :, per:].contiguous(), 7)
    kw.update(B=B - per, b_offset=per)
    name = "K1-w8a8" if quantize == "w8a8" else "K1"
    sample_check(K, shard, kw, f"dp {name}")
    mine = K.generate(*shard, **kw, mode="sampling")
    same = (torch.equal(mine[0], whole[0][:, :, per:])
            and torch.equal(mine[1], whole[1][:, per:])
            and torch.equal(mine[3], whole[3][:, per:]))
    phase("dp", f"{name} at b_offset {per} (B={B - per}, maxd {maxd}, {up} "
                f"steps, sampling): samples, rings and x equal to rows "
                f"{per}-{B - 1} of one B={B} call: {same}")
    check(same, f"{name}: a shard at its b_offset must draw the whole "
                f"batch's rows")


def dp_decode_smoke(dev, card, case4):
    """Phase 18's decodes: K1 at the shard's shape, then phase 4's batch
    and a deep w8a8 batch over two shards of the card, each bit-equal to
    one call; returns the K1 and K1-w8a8 launches of the sharded runs."""
    import torch

    from qpnet_tpu_torch.config import ModelConfig
    from qpnet_tpu_torch.models import generate as G
    from qpnet_tpu_torch.models.qpnet import init_params
    from qpnet_tpu_torch.ops import gen_kernel as K
    from qpnet_tpu_torch.parallel import Mesh
    cfg = ModelConfig()
    up = cfg.upsampling_factor
    params = init_params(0, cfg, device=dev)
    x, h, n_samples, d = (case4[k] for k in ("x", "h", "n_samples", "d"))
    B = h.shape[0]
    per = B // DP_SHARDS
    shard_dev = (f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda"
                 else dev)
    mesh = Mesh([shard_dev] * DP_SHARDS)

    # K1 at the second shard's shape: forced on phase 3's f64 gate ...
    rng = np.random.default_rng(18)
    path_shape_check(K, params, cfg, h[per:], d[per:, ::up], 1, rng, dev,
                     "dp")
    # ... and at b_offset = per against its twin and one whole-batch call
    offset_check(K, params, cfg, h, d, per, dev)

    # the main path: phase 4's batch over two shards of the card
    ref = {"sampling": case4["out"]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref["argmax"] = G.batch_fast_generate(params, cfg, x, h, n_samples, d,
                                          seed=100, mode="argmax", device=dev)
    one_wall = {"sampling": case4["wall"],
                "argmax": time.perf_counter() - t0}
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_count()
    torch.cuda.synchronize()
    walls = {}
    for mode in ("sampling", "argmax"):
        t0 = time.perf_counter()
        out = G.batch_fast_generate(params, cfg, x, h, n_samples, d,
                                    seed=100, mode=mode, mesh=mesh)
        torch.cuda.synchronize()
        walls[mode] = time.perf_counter() - t0
        same = len(out) == B and all(np.array_equal(a, b)
                                     for a, b in zip(out, ref[mode]))
        phase("dp", f"batch_fast_generate {mode}, B={B} over {mesh}: "
                    f"samples equal to one call's bit for bit: {same}")
        check(same, f"sharded {mode} decode must equal one call")
    k1 = K.launch_count
    mem_dec = peak_mib(dev)
    check(k1 > 0, "the sharded decode must launch K1")
    del params
    torch.cuda.empty_cache()

    # w8a8: the deep net, B=8 as 2 x 4
    dcfg = ModelConfig.from_network_name(DEEP)
    dparams = init_params(0, dcfg, device=dev)
    xw, hw, nw, dw = make_inputs(rng, dcfg, sorted(
        int(f) for f in rng.integers(10, 20, size=8)))
    offset_check(K, dparams, dcfg, hw, dw, 8 // DP_SHARDS, dev, "w8a8")
    one = G.batch_fast_generate(dparams, dcfg, xw, hw, nw, dw, seed=100,
                                quantize="w8a8", device=dev)
    K.reset_launch_count()
    two = G.batch_fast_generate(dparams, dcfg, xw, hw, nw, dw, seed=100,
                                quantize="w8a8", mesh=mesh)
    w8 = K.w8a8_launch_count
    same = all(np.array_equal(a, b) for a, b in zip(one, two))
    phase("dp", f"{DEEP} w8a8, B=8 as {DP_SHARDS} x 4, sampling: equal to "
                f"one B=8 call bit for bit: {same}; K1-w8a8 launches {w8}")
    check(same and w8 > 0, "sharded w8a8 decode must equal one call")
    del dparams
    torch.cuda.empty_cache()
    phase("time", f"sharded decode walls: B={B} sampling "
                  f"{walls['sampling']:.3f} s over {DP_SHARDS} shards of one "
                  f"card against {one_wall['sampling']:.3f} s in one call "
                  f"(phase 4), argmax "
                  f"{walls['argmax']:.3f} against {one_wall['argmax']:.3f} "
                  f"(the shards queue on one card: no speed-up is claimed); "
                  f"K1 launches {k1}; peak device memory {mem_dec:.1f} MiB "
                  f"| {card}")
    return k1, w8


def dp_train_smoke(card, step_ms):
    """Phase 18's training: two `qpnet_train` processes joined as two hosts
    on the card, then the preemption pair; returns the ranks' (forward,
    backward) K2 launches."""
    import re
    import shutil

    from qpnet_tpu_torch.config import ModelConfig
    cfg = ModelConfig()
    tmp = tempfile.mkdtemp(prefix="qp18_")
    try:
        wav_scp, feat_scp, stats = _dp_corpus(tmp, cfg)
        expdir = os.path.join(tmp, "exp")
        argv = ["--waveforms", wav_scp, "--feats", feat_scp, "--stats", stats,
                "--expdir", expdir, "--config", os.path.join(tmp, "m.conf"),
                "--batch_length", "20000", "--max_length", "30000",
                "--batch_size", "2", "--iters", str(DP_ITERS),
                "--checkpoint_interval", str(DP_ITERS), "--intervals", "1",
                "--fixed_engine", "pallas", "--dtype", "float32",
                "--device", "cuda", "--verbose", "1"]
        # the preemption pair, started beside the training pair: host 0
        # alone is preempted, and both must stop at the same iteration
        pre = os.path.join(tmp, "preempt")
        pre_argv = argv[:]
        for flag, value in (("--expdir", pre),
                            ("--config", os.path.join(tmp, "p.conf")),
                            ("--batch_length", "2200"),
                            ("--max_length", "3300"), ("--iters", "50"),
                            ("--checkpoint_interval", "100"),
                            ("--fixed_engine", "xla")):
            pre_argv[pre_argv.index(flag) + 1] = value
        (outs, wall), (pre_outs, pre_wall) = _dp_hosts(
            [(argv, lambda hid: {}),
             (pre_argv, lambda hid: {"QPNET_PREEMPT_AFTER": "3"}
              if hid == 0 else {})])
        logged = [re.findall(r"average loss = ([0-9.]+) \(([0-9.]+) sec",
                             o) for o in outs]
        losses = [[float(v) for v, _ in lg] for lg in logged]
        sums = [re.findall(r"parameter checksum (\S+) equal on the 2 ranks",
                           o) for o in outs]
        reduce_ms = [re.findall(r"all-reduces over (\w+), ([0-9.]+) ms each",
                                o) for o in outs]
        ranks = [_rank_line(o) for o in outs]
        k2 = tuple(sum(r[k] for r in ranks) for k in ("fwd", "bwd"))
        shared = all("gradient all-reduce over gloo (the ranks share a card)"
                     in o for o in outs)
        phase("dp", f"qpnet_train as 2 hosts on one card, kernel engine, f32, "
                    f"global batch 2, T=30030, {DP_ITERS} iterations: losses "
                    f"{losses[0]} and {losses[1]}; parameter checksums "
                    f"{sums[0]} {sums[1]}; gradients over gloo (ranks share "
                    f"the card) logged by both: {shared}; K2 launches fwd "
                    f"{k2[0]} bwd {k2[1]}")
        check(len(losses[0]) == DP_ITERS and losses[0] == losses[1]
              and all(np.isfinite(losses[0])), "both ranks must log the "
                                                "same finite losses")
        check(len(sums[0]) == 1 and sums[0] == sums[1],
              "the replicas' parameter checksums must agree")
        check(shared, "the log must name gloo as the gradients' backend")
        check(min(k2) > 0, f"every rank must launch K2, got {k2}")
        for name in (f"checkpoint-{DP_ITERS}.pkl", "checkpoint-final.pkl"):
            check(os.path.exists(os.path.join(expdir, name)), name)
        check("checkpoint created" in outs[0]
              and "checkpoint created" not in outs[1],
              "only the lead rank writes checkpoints")
        ms_it = ", ".join(f"{float(s) * 1e3:.0f}" for _, s in logged[0][1:])
        phase("time", f"dp training: {wall:.3f} s for both processes "
                      f"(start-up, corpus, build cache, 4 iterations, "
                      f"checkpoints; the preemption pair below ran beside "
                      f"them); ms per iteration after the first "
                      f"(host 0's log) {ms_it} against phase 8's "
                      f"one-process kernel-engine step "
                      f"{step_ms:.3f} ms; gradient all-reduce "
                      f"{reduce_ms[0][0][1]} and {reduce_ms[1][0][1]} ms per "
                      f"step over {reduce_ms[0][0][0]} (host clock); peak "
                      f"device memory per "
                      f"rank {ranks[0]['peak_mib']:.1f} and "
                      f"{ranks[1]['peak_mib']:.1f} MiB | {card}")

        # preemption on host 0 only stops both at the same iteration
        n_it = [len(re.findall(r"average loss", o)) for o in pre_outs]
        stopped = (os.path.exists(os.path.join(pre, "checkpoint-4.pkl"))
                   and not os.path.exists(os.path.join(pre,
                                                       "checkpoint-final.pkl"))
                   and "preemption at iteration 4" in pre_outs[0])
        phase("dp", f"QPNET_PREEMPT_AFTER=3 on host 0 only (plain engine, "
                    f"3,300-sample window): iterations run {n_it}, "
                    f"checkpoint-4.pkl and no checkpoint-final.pkl: {stopped} "
                    f"({pre_wall:.3f} s, beside the training pair)")
        check(n_it == [4, 4] and stopped, "preemption must stop both hosts "
                                          "at iteration 4")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return k2


# --- phase 19: deep-net training on the card ---------------------------------

DEEP_ITERS = 100     # each engine: the loss gate's first and last 50


def deep_train_smoke(dev, card):
    """Phase 19: K2 against its twins at the deep net's geometry, its times
    there, then the deep tool's loop through both engines; returns one
    record per K2 row (forward, backward), each with the kernel engine's
    launches on the loop."""
    import torch

    from qpnet_tpu_torch.models.qpnet import init_params
    from qpnet_tpu_torch.ops import train_kernel as TK
    from qpnet_tpu_torch.tools import deep_train_smoke as DT
    t_phase = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16
    cfg, batch_length, max_length, batch_size = DT.registry_geometry()
    utts = DT.synthetic_utterances(up=cfg.upsampling_factor, n_aux=cfg.n_aux)
    batch = next(DT.window_stream(cfg, utts, batch_length, max_length,
                                  batch_size))
    batch.pop("window_lens")
    T = batch["x"].shape[1]
    params = init_params(0, cfg, device=dev)
    errs, twin_ms = {}, {}
    for dtype in (f32, bf16):
        for fused in (False, True):
            errs[(dtype, fused)], twin_ms[(dtype, fused)] = k2_check(
                params, cfg, batch, dtype, fused, dev, "deep k2")
            torch.cuda.empty_cache()
    times = {dtype: k2_times(params, cfg, batch, dtype,
                             twin_ms[(dtype, False)], dev, card,
                             f"{DT.NETWORK} ")
             for dtype in (f32, bf16)}
    del params
    torch.cuda.empty_cache()

    # the main path: the deep tool's loop in bf16 through both engines
    runs = {}
    for engine in ("pallas", "xla"):
        TK.reset_launch_counts()
        out = DT.train_run(cfg, DEEP_ITERS, "bfloat16", remat=True,
                           device=dev, fixed_engine=engine,
                           batch_length=batch_length, max_length=max_length,
                           batch_size=batch_size, utts=utts,
                           log=lambda msg: phase("deep", msg))
        launches = (TK.fwd_launch_count, TK.bwd_launch_count)
        losses = out.pop("losses")
        runs[engine] = launches
        phase("deep", json.dumps(out))
        phase("time", f"deep-net training, {engine} engine, bf16, B=1, "
                      f"T={T}: {out['ms_per_step_median']:.3f} ms per step "
                      f"(median after 10), first step {out['compile_s']:.3f} "
                      f"s; losses {losses[0]:.4f} -> {losses[-1]:.4f}, mean "
                      f"of the first 50 {out['loss_first50_mean']} and of "
                      f"the last 50 {out['loss_last50_mean']}; K2 launches "
                      f"fwd {launches[0]} bwd {launches[1]}; peak device "
                      f"memory {out['peak_device_mib']:.1f} MiB | {card}")
        check(all(np.isfinite(losses)), f"deep {engine}: finite losses")
        check(out["loss_decreased"], f"deep {engine}: the loss gate (the "
                                     f"last 50 below the first 50)")
        want = (DEEP_ITERS, DEEP_ITERS) if engine == "pallas" else (0, 0)
        check(launches == want, f"deep {engine}: K2 launches {launches}, "
                                f"expected {want}")
        torch.cuda.empty_cache()
    phase("deep", f"phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return [dict(launches=runs["pallas"][i], T=T,
                 max_abs_err=errs[(f32, False)][i],
                 **times[f32][name],
                 bf16_ms=times[bf16][name]["ms"],
                 bf16_bound_ms=times[bf16][name]["bound_ms"],
                 bf16_library_ms=times[bf16][name]["library_ms"])
            for i, name in enumerate(("fwd", "bwd"))]


# --- phases 20-22: model parallelism on one card ----------------------------

TP_STEPS = 4
TP_LR = 1e-4


def mp_batches(cfg, B):
    """TP_STEPS batches of B windows of 3,300 samples from phase 7's
    in-memory corpus (phases 20-22)."""
    from qpnet_tpu_torch.data import batcher as DB
    utts, scaler = memory_corpus(cfg, seed=7)
    stream = DB.window_batches(
        DB.utterance_stream(utts, lambda u: u, seed=1), cfg,
        feat_transform=scaler.transform, batch_length=2200, batch_size=B,
        max_length=3300)
    batches = [next(stream) for _ in range(TP_STEPS)]
    for b in batches:
        b.pop("window_lens")
    return batches


def relu_branches(masks=None):
    """(a stand-in for torch.nn.functional inside models/qpnet.py, the list
    it fills): its relu records each input, the post-net's two (the skip
    sum, then the first product), and with `masks` takes those 0/1
    branches instead of z > 0.  The rest is torch's."""
    import types

    import torch
    import torch.nn.functional as F
    seen = []

    def relu(z):
        seen.append(z.detach())
        return torch.relu(z) if masks is None else z * masks[len(seen) - 1]

    return types.SimpleNamespace(**{**vars(F), "relu": relu}), seen


def mp_reference(cfg, batches, dev):
    """One process's TP_STEPS steps on the batches (plain engine, f32,
    parameters of seed 0) and step 1's gradient in float64 from the same
    parameters and batch, twice: at float64's own ReLU branches ("g64"),
    and at the branches of one process's f32 forward ("g64m"), which
    differ where a post-net input lies within f32 rounding of 0 ("kinks":
    per ReLU input the branches that differ, the largest |f32 - f64|, the
    inputs within it of 0); what phases 20-22 hold their ranks to."""
    from unittest import mock

    import torch

    from qpnet_tpu_torch.models import qpnet as Q
    from qpnet_tpu_torch.models.qpnet import init_params, tree_map
    from qpnet_tpu_torch.parallel import dryrun
    from qpnet_tpu_torch.train import step as TS
    rep = {}
    losses, params = dryrun.steps(cfg, batches, dev, engine="xla", lr=TP_LR,
                                  report=rep)
    batch = TS.batch_to_device(batches[0], dev)

    def loss_at(dtype, masks=None):
        p = tree_map(lambda t: t.to(dtype).requires_grad_(),
                     init_params(0, cfg, device=dev))
        shim, seen = relu_branches(masks)
        with mock.patch.object(Q, "F", shim):
            loss = TS._loss_fn(p, cfg, batch, dtype, False)
        return p, loss, seen

    with torch.no_grad():
        z32 = loss_at(torch.float32)[2]
    grads = {}
    for key, masks in (("g64", None),
                       ("g64m", [(z > 0).double() for z in z32])):
        p64, loss, z64 = loss_at(torch.float64, masks)
        loss.backward()
        grads[key] = [np.zeros(tuple(p.shape)) if p.grad is None
                      else p.grad.cpu().numpy() for p in TS.tree_leaves(p64)]
        if masks is None:
            names = TS.tree_leaves(tree_names(p64))
            kinks = []
            for a, b in zip(z32, z64):
                err = float((a.double() - b).abs().max())
                kinks.append({"flips": int(((a > 0) != (b > 0)).sum()),
                              "rounding": err,
                              "near_0": int((b.abs() <= err).sum()),
                              "inputs": b.numel()})
        del p64, loss, z64
    return {"batches": batches, "losses": losses, "params": params,
            "rep": rep, "names": names, "kinks": kinks, **grads}


def kink_line(ref):
    """The post-net's ReLU inputs that one process's f32 forward puts on
    the other branch, and its f32 gradient's distance (the worst leaf,
    |d| / |f64|) to the f64 gradient at f64's branches and at its own."""
    worst = [max(norm_rel(go, g, g) for go, g in zip(ref["rep"]["grads"],
                                                     ref[key]))
             for key in ("g64", "g64m")]
    return (f"post-net ReLU inputs (skip sum, first product) of step 1, one "
            f"process's f32 forward against f64: "
            + "; ".join(f"{k['flips']} on the other branch, {k['near_0']} "
                        f"of {k['inputs']} within the largest |f32 - f64| "
                        f"({k['rounding']:.2e}) of 0" for k in ref["kinks"])
            + f"; one process's f32 gradient, the worst leaf, {worst[0]:.2e} "
              f"from f64 at f64's branches and {worst[1]:.2e} at its own")


def norm_rel(a, b, scale):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(scale), 1e-30))


def held_to_reference(tag, losses, rep, ref, loss_tol, either=False):
    """One rank's losses (relative, within loss_tol) and step 1's gradients
    against `mp_reference`: every leaf within 1e-4 of the float64
    gradient's norm, measured as |d| / |f64|, at f64's ReLU branches or,
    with `either`, all of them at one process's f32 branches.  Returns
    (the line that describes them, the gates that failed); the caller
    prints the line before it checks.  A post-net ReLU input within f32
    rounding of 0 takes the other branch in an f32 forward (`kink_line`)
    and moves the gradient by 2e-4 to 1e-3 of a leaf's norm; f32 ranks
    that sum that input as one process does take it too."""
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(losses, ref["losses"]))
    rows = sorted(((norm_rel(gr, g, g), norm_rel(gr, gm, g), n)
                   for n, gr, g, gm in zip(ref["names"], rep["grads"],
                                           ref["g64"], ref["g64m"])),
                  reverse=True)
    worst = [max(row[i] for row in rows) for i in (0, 1)]
    held = "f64's branches" if worst[0] <= 1e-4 else \
        "one process's f32 branches" if either and worst[1] <= 1e-4 else None
    failed = [f"{tag}: losses off by {loss_rel}"] if loss_rel > loss_tol \
        else []
    failed += [f"{tag}: gradients off the f64 gradient: {rows[:8]}"] \
        if held is None else []
    text = (f"losses {[round(x, 7) for x in losses]} against one process's "
            f"{[round(x, 7) for x in ref['losses']]} (max rel "
            f"{loss_rel:.2e}, tol {loss_tol:g}); step 1's gradients per "
            f"leaf, |rank - f64| over |f64| at f64's branches and at one "
            f"process's f32 branches, the worst five: "
            + "; ".join(f"{n} {a:.2e} {b:.2e}" for a, b, n in rows[:5])
            + f"; the worst leaf {worst[0]:.2e} and {worst[1]:.2e}; every "
              f"leaf within 1e-4 at {held or 'neither'}")
    return text, failed


def gate(failed):
    for what in failed:
        check(False, what)


def rank_devices(dev, n):
    import torch
    return [f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda"
            else str(dev)] * n


def step_ms_line(ranks):
    """Each rank's median ms per step over steps 2-TP_STEPS."""
    return ", ".join(f"{float(np.median(out[-1]['step_ms'][1:])):.3f}"
                     for out in ranks)


PP_M = 2


def mp_smoke(dev, card, step_ms):
    """Phases 20-22: one spawn of four gloo ranks on the card runs, in
    turn, (dp=1, tp=2), (dp=1, sp=2) and (dp=1, pp=2) (its logits, then
    its steps) on ranks 0-1 and (dp=1, tp=2, sp=2) on all four, so a rank
    pays its start-up once; then each phase holds its legs to one process
    on the same batches (`mp_reference`)."""
    import dataclasses

    from qpnet_tpu_torch.config import ModelConfig
    from qpnet_tpu_torch.models.qpnet import init_params, tree_map
    from qpnet_tpu_torch.parallel import dryrun
    t_phase = time.perf_counter()
    cfg = ModelConfig()
    ref1 = mp_reference(cfg, mp_batches(cfg, 1), dev)
    ref2 = mp_reference(cfg, mp_batches(cfg, 2), dev)
    params = tree_map(lambda t: t.cpu().numpy(),
                      init_params(0, cfg, device=dev))

    def steps(ref, **kw):
        return dryrun.steps_args(cfg, ref["batches"], True, engine="xla",
                                 lr=TP_LR, **kw)

    devices = rank_devices(dev, 4)
    t0 = time.perf_counter()
    tp, sp, logits, pp, tp_sp = dryrun.run_legs(4, [
        (2, {"tp": 2}, dryrun.steps_job, steps(ref1)),
        (2, {"sp": 2}, dryrun.steps_job, steps(ref1)),
        (2, {"pp": 2}, dryrun.pp_logits, {
            "cfg": dataclasses.asdict(cfg), "params": params,
            "batch": ref2["batches"][0], "M": PP_M, "dtypes": ("float32",)}),
        (2, {"pp": 2}, dryrun.steps_job, steps(ref2, n_microbatches=PP_M)),
        (4, {"tp": 2, "sp": 2}, dryrun.steps_job, steps(ref1))], devices,
        timeout=600)
    phase("time", f"phases 20-22's five legs on 4 gloo ranks of the card: "
                  f"{time.perf_counter() - t0:.3f} s with the ranks' "
                  f"start-up (one spawn) | {card}")
    tp_smoke(card, step_ms, ref1, tp, devices)
    sp_smoke(card, ref1, {"sp": sp, "tp, sp": tp_sp}, devices)
    pp_smoke(card, ref2, logits, pp, devices)
    phase("mp", f"phases 20-22 took {time.perf_counter() - t_phase:.1f} s")


def tp_smoke(card, step_ms, ref, ranks, devices):
    """Phase 20: the (dp=1, tp=2) leg against one process on the same
    batches."""
    from qpnet_tpu_torch.config import ModelConfig
    cfg = ModelConfig()
    phase("tp", f"B=1: {kink_line(ref)}")
    T = ref["batches"][0]["x"].shape[1]
    for r, (losses, leaves, rep) in enumerate(ranks):
        held, failed = held_to_reference(f"tp rank {r}", losses, rep, ref,
                                         2e-5)
        # the final parameters are printed, not gated: Adam's first steps
        # move an element by about lr whatever its gradient's size, so an
        # element whose gradient is within the two runs' difference of 0
        # moves the other way; the losses of steps 2-4 hold the parameters
        param_d, param_rel, param_leaf = max(
            (float(np.abs(a - b).max()),
             float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)), n)
            for n, a, b in zip(ref["names"], leaves, ref["params"]))
        layout = tree_layout(rep["checkpoint"]) == tree_layout(
            ref["rep"]["checkpoint"])
        phase("tp", f"rank {r} of (dp=1, tp=2) on {devices[r]}, default "
                    f"net, f32, plain engine, B=1 T={T}, {TP_STEPS} steps: "
                    f"{held}; final parameters against one process's, the "
                    f"worst leaf {param_leaf}: max |d| {param_d:.3e} = "
                    f"{param_d / TP_LR:.3f} lr, max |d| / max |ref| "
                    f"{param_rel:.2e} (not gated); W_cur shard "
                    f"{rep['W_cur']}; the gathered checkpoint's layout "
                    f"equal to one process's: {layout}")
        gate(failed)
        check(rep["W_cur"] == (cfg.n_resch, cfg.n_resch),
              f"tp rank {r}: W_cur shard {rep['W_cur']} must hold 2R/2 "
              f"columns")
        check(layout, f"tp rank {r}: checkpoint layout")
    phase("time", f"tp on one card (2 gloo ranks, T={T}): "
                  f"{step_ms_line(ranks)} ms per step (median of steps "
                  f"2-{TP_STEPS}, host clock to the loss), one process "
                  f"{float(np.median(ref['rep']['step_ms'][1:])):.3f} ms on "
                  f"the same batches, phase 8's plain f32 step at T=30030 "
                  f"{step_ms:.3f} ms (bits, not speed) | {card}")


# --- phase 21: sequence parallelism on one card ------------------------------

def sp_smoke(card, ref, legs, devices):
    """Phase 21: the (dp=1, sp=2) and (dp=1, tp=2, sp=2) legs against
    phase 20's one process on the same batches."""
    from qpnet_tpu_torch.config import ModelConfig
    cfg = ModelConfig()
    batches = ref["batches"]
    T = batches[0]["x"].shape[1]
    maxd = float(batches[-1]["d"].max())
    bound = list(cfg.dilationsF) + [int(np.ceil(maxd * dil))
                                    for dil in cfg.dilationsA]
    for axes, ranks in legs.items():
        name = ", ".join(f"{k}=2" for k in axes.split(", "))
        for r, (losses, _, rep) in enumerate(ranks):
            held, failed = held_to_reference(f"sp rank {r} ({name})",
                                             losses, rep, ref, 2e-5, True)
            phase("sp", f"rank {r} of (dp=1, {name}) on {devices[r]}, "
                        f"default net, f32, plain engine, B=1 T={T}, "
                        f"{TP_STEPS} steps: local x {rep['x']}; the last "
                        f"step's agreed halo per block {rep['halos']} beside "
                        f"maxd*dil {bound} (maxd {maxd:.3f}); {held}")
            gate(failed)
            check(rep["x"] == (1, T // 2),
                  f"sp rank {r}: local x {rep['x']}, expected T/2")
            check(all(H <= b for H, b in zip(rep["halos"], bound)),
                  f"sp rank {r}: halos {rep['halos']} beyond {bound}")
        phase("time", f"(dp=1, {name}) on one card ({len(ranks)} gloo "
                      f"ranks, T={T}): {step_ms_line(ranks)} ms per step "
                      f"(median of steps 2-{TP_STEPS}, host clock to the "
                      f"loss), one process "
                      f"{float(np.median(ref['rep']['step_ms'][1:])):.3f} "
                      f"ms on the same batches (bits, not speed) | {card}")


# --- phase 22: pipeline parallelism on one card ------------------------------

def pp_smoke(card, ref, logits, ranks, devices):
    """Phase 22: the (dp=1, pp=2) leg, GPipe over PP_M microbatches of
    B=2, against one process on the same batches."""
    from qpnet_tpu_torch.train.pipeline import bubble_share
    phase("pp", f"B=2: {kink_line(ref)}")
    T = ref["batches"][0]["x"].shape[1]
    got, want = logits[-1]["float32"]
    check(logits[0] == {}, "pp: stage 0 returned logits")
    phase("pp", f"(dp=1, pp=2) GPipe, {PP_M} microbatches of B=2 T={T}, "
                f"default net, f32, plain engine: the last stage's logits "
                f"bit-equal to one process's forward: "
                f"{np.array_equal(got, want)} (max |d| "
                f"{float(np.abs(got - want).max()):.3e}, max |ref| "
                f"{float(np.abs(want).max()):.3e}; printed, not gated: "
                f"cuBLAS may sum the products of another row count in "
                f"another order); bubble share (S-1)/(M+S-1) = "
                f"{bubble_share(2, PP_M):.3f}")
    for r, (losses, _, rep) in enumerate(ranks):
        held, failed = held_to_reference(f"pp stage {r}", losses, rep, ref,
                                         1e-5, True)
        phase("pp", f"stage {r} of (dp=1, pp=2) on {devices[r]}, "
                    f"{TP_STEPS} steps: {held}")
        gate(failed)
    phase("time", f"pp on one card (2 gloo ranks, B=2 T={T}, M={PP_M}): "
                  f"{step_ms_line(ranks)} ms per step (median of steps "
                  f"2-{TP_STEPS}, host clock to the loss), one process "
                  f"{float(np.median(ref['rep']['step_ms'][1:])):.3f} ms on "
                  f"the same batches (bits, not speed) | {card}")


def tree_layout(tree, prefix=""):
    """{path: (shape, dtype)} of a checkpoint-like tree of arrays."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in
                tree_layout(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, item in enumerate(tree) for k, v in
                tree_layout(item, f"{prefix}/{i}").items()}
    a = np.asarray(tree)
    return {prefix: (a.shape, str(a.dtype))}


if __name__ == "__main__":
    sys.exit(main())
