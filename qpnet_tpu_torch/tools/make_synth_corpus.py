"""Synthetic voiced corpus generator — run the full recipe without VCC2018;
the port's copy of `qpnet_tpu/tools/make_synth_corpus.py` (the same numpy
stream, so one seed gives the same wavs, lists and conf bytes).

The reference assumes the (licensed) VCC2018 corpus is on disk
(reference README.md:61-75); the end-to-end exercises of this framework —
CI-scale tests, the recipe's run on the card — instead use deterministic
synthetic speech-like signals.  This tool makes those corpora
reproducible: formant-filtered harmonic sources with vibrato, pitch
drift, amplitude modulation, breath noise and unvoiced/silent spans (so
VAD, uv decisions and continuous-F0 interpolation are all exercised),
laid out exactly as the recipe expects:

    <corpus_dir>/wav/<subset>/<speaker>/<nnnnn>.wav

plus scp lists (train/update/validation/evaluation per speaker and
global) and a curated conf/pow_f0_dict.yml whose per-speaker F0 ranges
bracket the generated pitch — i.e. after this tool runs, `runFE` steps
2-4 and the whole `runQP` stage ladder work unmodified, same as against
the reference corpus layout (reference corpus/VCC2018/scp, run_FE.sh).

Usage:
    python -m qpnet_tpu_torch.tools.make_synth_corpus \
        --corpus_dir corpus/SYNTH --fs 22050 --speakers 2 \
        --train_utts 20 --seconds 3.0
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from scipy.io import wavfile

from qpnet_tpu_torch.data.lists import write_txt
from qpnet_tpu_torch.utils import yamlconf


def _pink_noise(rng: np.random.Generator, n: int) -> np.ndarray:
    """Approximate 1/f noise via a few octave-spaced white-noise layers."""
    out = np.zeros(n)
    amp, step = 1.0, 1
    while step < n:
        w = rng.standard_normal(-(-n // step))
        out += amp * np.repeat(w, step)[:n]
        amp *= 0.7
        step *= 2
    return out / np.max(np.abs(out) + 1e-9)


def _formant_filter(x: np.ndarray, fs: int, formants, bws) -> np.ndarray:
    """Cascade of resonator biquads (two-pole sections) — the classic
    source-filter vowel model."""
    from scipy.signal import lfilter

    y = x
    for fc, bw in zip(formants, bws):
        r = np.exp(-np.pi * bw / fs)
        theta = 2 * np.pi * fc / fs
        a1, a2 = -2 * r * np.cos(theta), r * r
        b0 = (1 - r) * np.sqrt(1 - 2 * r * np.cos(2 * theta) + r * r)
        y = lfilter([b0], [1.0, a1, a2], y)
    return y


def synth_utterance(rng: np.random.Generator, fs: int, seconds: float,
                    f0_base: float) -> np.ndarray:
    """One speech-like utterance: voiced vowel-ish spans separated by an
    unvoiced fricative-ish span and lead-in/out silence."""
    n = int(seconds * fs)
    t = np.arange(n) / fs

    # --- segmentation: silence | voiced | unvoiced | voiced | silence
    sil = int(0.08 * fs)
    unv0 = int(n * (0.40 + 0.10 * rng.random()))
    unv1 = unv0 + int((0.06 + 0.06 * rng.random()) * fs)
    voiced_mask = np.zeros(n, bool)
    voiced_mask[sil:unv0] = True
    voiced_mask[unv1:n - sil] = True

    # --- F0 trajectory: base pitch, slow drift, 5.5 Hz vibrato
    drift = f0_base * 0.12 * np.sin(2 * np.pi * (0.35 + 0.2 * rng.random())
                                    * t + rng.random() * 6.28)
    vib = f0_base * 0.03 * np.sin(2 * np.pi * 5.5 * t)
    f0 = f0_base + drift + vib

    # --- harmonic source: additive synthesis with a -6 dB/oct rolloff
    phase = 2 * np.pi * np.cumsum(f0) / fs
    src = np.zeros(n)
    kmax = int(0.45 * fs / (f0_base * 1.2))
    for k in range(1, max(2, kmax)):
        src += np.sin(k * phase + rng.random() * 6.28) / k
    # jitter/shimmer so envelope estimates are not laboratory-clean
    src *= 1.0 + 0.05 * _pink_noise(rng, n)

    # --- vowel formants (randomized around a vowel chart region)
    formants = [700 * (0.8 + 0.4 * rng.random()),
                1400 * (0.8 + 0.4 * rng.random()),
                2600 * (0.85 + 0.3 * rng.random())]
    bws = [90, 120, 180]
    voiced = _formant_filter(src, fs, formants, bws)
    # glottal leakage: resonators attenuate the fundamental ~30 dB below
    # the F1 region, which defeats interval-agreement F0 estimators (and
    # is unrealistically weak next to real phonation) — mix the
    # fundamental back at a natural level
    fund = np.sin(phase)
    voiced = voiced / np.max(np.abs(voiced) + 1e-9) + 0.45 * fund
    voiced += 0.01 * rng.standard_normal(n)          # breath noise

    # --- unvoiced span: high-passed noise burst (fricative-ish)
    noise = rng.standard_normal(n)
    fric = _formant_filter(noise, fs, [3600.0], [900.0])

    # --- amplitude envelope: syllable-rate AM + segment gating with
    # 10 ms raised-cosine edges so segment switches don't click
    am = 0.75 + 0.25 * np.sin(2 * np.pi * (2.0 + rng.random()) * t
                              + rng.random() * 6.28)
    edge = int(0.010 * fs)
    ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(edge) / edge)

    def gate(mask):
        g = mask.astype(float)
        d = np.diff(g, prepend=0.0)
        for i in np.where(d > 0)[0]:
            g[i:i + edge] = np.minimum(g[i:i + edge], ramp[:n - i][:edge])
        for i in np.where(d < 0)[0]:
            j = max(0, i - edge)
            g[j:i] = np.minimum(g[j:i], ramp[::-1][edge - (i - j):])
        return g

    unv_mask = np.zeros(n, bool)
    unv_mask[unv0:unv1] = True
    x = (voiced / np.max(np.abs(voiced) + 1e-9)) * gate(voiced_mask) * am
    x += 0.25 * (fric / np.max(np.abs(fric) + 1e-9)) * gate(unv_mask)
    return (0.6 * x / np.max(np.abs(x) + 1e-9)).astype(np.float64)


def _write_wav(path: str, x: np.ndarray, fs: int) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    wavfile.write(path, fs, (np.clip(x, -1, 1) * 32767).astype(np.int16))


def make_corpus(corpus_dir: str, fs: int = 22050, speakers: int = 2,
                train_utts: int = 20, update_utts: int = 8,
                valid_utts: int = 4, eval_utts: int = 4,
                seconds: float = 3.0, seed: int = 0) -> dict:
    """Generate waves + scp lists + conf. Returns {speaker: f0_base}."""
    rng = np.random.default_rng(seed)
    scp_dir = os.path.join(corpus_dir, "scp")
    conf_dir = os.path.join(corpus_dir, "conf")
    os.makedirs(scp_dir, exist_ok=True)
    os.makedirs(conf_dir, exist_ok=True)

    spk_f0 = {}
    conf = {}
    lists = {"tr": [], "up": [], "va": [], "ev": []}
    per_spk = {}
    for s in range(speakers):
        spk = f"SYN{s + 1}"
        f0_base = float(rng.uniform(95.0, 240.0))
        spk_f0[spk] = f0_base
        conf[spk] = {"f0_min": int(max(40, f0_base * 0.6)),
                     "f0_max": int(f0_base * 1.6),
                     "pow_th": -40}
        per_spk[spk] = {"tr": [], "up": [], "va": [], "ev": []}
        # reference convention (corpus/VCC2018/scp): the SD update and
        # validation utterances are drawn FROM the training subset and
        # appear in the global training list (vcc18up/vcc18va are subsets
        # of vcc18tr) — so run_FE stage 4's noise shaping over the
        # training list covers everything the trainers will read
        # cumulative numbering blocks so no subset can overwrite another
        # regardless of the requested counts
        subsets = [("tr", "synth_training", 0, train_utts),
                   ("up", "synth_training", train_utts, update_utts),
                   ("va", "synth_training", train_utts + update_utts,
                    valid_utts),
                   ("ev", "synth_evaluation", 0, eval_utts)]
        for key, subset, base, count in subsets:
            for i in range(count):
                dur = seconds * (0.7 + 0.6 * rng.random())
                x = synth_utterance(rng, fs, dur, f0_base)
                rel = f"wav/{subset}/{spk}/{base + i + 1:05d}.wav"
                _write_wav(os.path.join(corpus_dir, rel), x, fs)
                lists[key].append("rootpath/" + rel)
                per_spk[spk][key].append("rootpath/" + rel)
                if key in ("up", "va"):
                    lists["tr"].append("rootpath/" + rel)
                    per_spk[spk]["tr"].append("rootpath/" + rel)

    names = {"tr": "synthtr", "up": "synthup", "va": "synthva",
             "ev": "syntheval"}
    for key, name in names.items():
        write_txt(os.path.join(scp_dir, f"{name}.scp"), lists[key])
        for spk, d in per_spk.items():
            write_txt(os.path.join(scp_dir, f"{name}_{spk}.scp"), d[key])
    yamlconf.write(os.path.join(conf_dir, "pow_f0_dict.yml"), conf)
    return spk_f0


def main(argv=None):
    p = argparse.ArgumentParser(
        description="generate a synthetic speech-like corpus in the "
                    "recipe's VCC2018-style layout")
    p.add_argument("--corpus_dir", required=True)
    p.add_argument("--fs", type=int, default=22050)
    p.add_argument("--speakers", type=int, default=2)
    p.add_argument("--train_utts", type=int, default=20)
    p.add_argument("--update_utts", type=int, default=8)
    p.add_argument("--valid_utts", type=int, default=4)
    p.add_argument("--eval_utts", type=int, default=4)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    spk_f0 = make_corpus(a.corpus_dir, a.fs, a.speakers, a.train_utts,
                         a.update_utts, a.valid_utts, a.eval_utts,
                         a.seconds, a.seed)
    for spk, f0 in sorted(spk_f0.items()):
        print(f"{spk}: base F0 {f0:.1f} Hz")
    print(f"corpus at {a.corpus_dir} (scp prefix 'synth*')")


if __name__ == "__main__":
    main()
