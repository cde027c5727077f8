"""Speaker-statistics initializer, the port of
`qpnet_tpu/bin/initialize_speaker.py` (reference
src/bin/initialize_speaker.py): per-speaker F0 and frame-power histograms
(PNG) so a human can set f0_min/f0_max/pow_th in conf/pow_f0_dict.yml.
Same argv; the F0 and power come from the host WORLD analysis, bit-equal
to the JAX package's.

The histograms are drawn without matplotlib (the card's machine has none):
the 200-bin density histogram `plt.hist(..., density=True)` draws, filled,
on a 640x480 canvas with its x ticks and their values, written as PNG with
zlib; the axis labels go into the file's text chunks.

  python -m qpnet_tpu_torch.bin.initialize_speaker --speaker SPK \\
      --waveforms wav.scp --figure_dir hist/ --n_jobs 4
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing as mp
import os
import struct
import zlib

import numpy as np
from scipy.io import wavfile

from qpnet_tpu_torch.data import find_files, read_txt
from qpnet_tpu_torch.dsp.world import WorldAnalyzer
from qpnet_tpu_torch.utils import multi_processing, set_loglevel

N_BINS = 200
WIDTH, HEIGHT = 640, 480
# the plot area, matplotlib's default subplot margins on that canvas
X0, X1, Y0, Y1 = 80, 576, 58, 422
BAR = (31, 119, 180)
# 3x5 glyphs of the tick values, one row of 3 bits per entry
_GLYPHS = {"0": (7, 5, 5, 5, 7), "1": (2, 6, 2, 2, 7), "2": (7, 1, 7, 4, 7),
           "3": (7, 1, 7, 1, 7), "4": (5, 5, 7, 1, 1), "5": (7, 4, 7, 1, 7),
           "6": (7, 4, 7, 5, 7), "7": (7, 1, 1, 1, 1), "8": (7, 5, 7, 5, 7),
           "9": (7, 5, 7, 1, 7), "-": (0, 0, 7, 0, 0)}


def write_png(path: str, rgb: np.ndarray, text: dict) -> None:
    """An 8-bit RGB PNG of rgb (H, W, 3) uint8, with tEXt chunks."""
    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)   # filter 0
    out = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    for k, v in text.items():
        out += chunk(b"tEXt", k.encode("latin-1") + b"\0"
                     + v.encode("latin-1"))
    out += chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
    out += chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


def _label(img: np.ndarray, text: str, cx: int, top: int) -> None:
    """Draw text in 2x-scaled glyphs, centred on column cx."""
    x = cx - 4 * len(text)
    for ch in text:
        for r, bits in enumerate(_GLYPHS[ch]):
            for c in range(3):
                if bits >> (2 - c) & 1:
                    img[top + 2 * r:top + 2 * r + 2,
                        x + 2 * c:x + 2 * c + 2] = 0
        x += 8


def create_histogram(data, figure_path, range_min=-70, range_max=20,
                     step=10, xlabel="Power [dB]") -> np.ndarray:
    """Draw the density histogram of data (200 bins over [range_min,
    range_max]) to figure_path as PNG; returns the densities drawn."""
    dens, _ = np.histogram(data, bins=N_BINS, range=(range_min, range_max),
                           density=True)
    img = np.full((HEIGHT, WIDTH, 3), 255, np.uint8)
    top = float(dens.max()) * 1.05 if np.isfinite(dens).all() else 0.0
    cols = np.arange(X0, X1)
    bins = (cols - X0) * N_BINS // (X1 - X0)
    if top > 0:
        tops = Y1 - np.round(dens[bins] / top * (Y1 - Y0)).astype(int)
        for x, t in zip(cols, tops):
            img[t:Y1, x] = BAR
    img[[Y0, Y1], X0:X1 + 1] = 0
    img[Y0:Y1 + 1, [X0, X1]] = 0
    for tick in np.arange(range_min, range_max, step):
        x = X0 + int(round((tick - range_min) / (range_max - range_min)
                           * (X1 - X0)))
        img[Y1:Y1 + 5, x] = 0
        _label(img, str(int(tick)), x, Y1 + 9)
    os.makedirs(os.path.dirname(figure_path), exist_ok=True)
    write_png(figure_path, img, {
        "Title": f"{xlabel}: {N_BINS}-bin density histogram",
        "x": f"{xlabel}, {range_min} to {range_max}",
        "y": f"Probability, 0 to {top:.6g}"})
    return dens


def world_feature_extract(wav_list, f0_dict, npow_dict):
    """Voiced F0 and frame power (dB) of each wav, by path."""
    for f in wav_list:
        wavf = f.rstrip()
        fs, x = wavfile.read(wavf)
        x = np.array(x, dtype=np.float64)
        logging.info("Extract: %s", wavf)
        analyzer = WorldAnalyzer(fs=fs, minf0=40, maxf0=800)
        f0, _, _ = analyzer.analyze(x)
        f0_dict[f] = f0[f0 > 0]
        npow_dict[f] = analyzer.npow()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--speaker", required=True, type=str)
    parser.add_argument("--waveforms", required=True, type=str)
    parser.add_argument("--figure_dir", required=True, type=str)
    parser.add_argument("--n_jobs", default=10, type=int)
    parser.add_argument("--verbose", default=1, type=int)
    args = parser.parse_args(argv)
    set_loglevel(args.verbose)

    if os.path.isdir(args.waveforms):
        file_list = sorted(find_files(args.waveforms, "*.wav"))
    else:
        file_list = read_txt(args.waveforms)
    logging.info("number of utterances = %d", len(file_list))

    # spawned workers (utils/multi_process.py) fill dicts a manager holds;
    # one job runs inline
    if max(1, min(args.n_jobs, len(file_list))) > 1:
        with mp.get_context("spawn").Manager() as manager:
            f0_dict, npow_dict = manager.dict(), manager.dict()
            multi_processing(file_list, world_feature_extract, args.n_jobs,
                             f0_dict, npow_dict)
            f0_dict, npow_dict = dict(f0_dict), dict(npow_dict)
    else:
        f0_dict, npow_dict = {}, {}
        world_feature_extract(file_list, f0_dict, npow_dict)

    empty = [np.zeros(0)]
    f0s = np.concatenate([f0_dict[f] for f in file_list] or empty)
    npows = np.concatenate([npow_dict[f] for f in file_list] or empty)
    spk = args.speaker
    create_histogram(f0s, os.path.join(args.figure_dir,
                                       f"{spk}_f0histogram.png"),
                     range_min=40, range_max=700, step=50,
                     xlabel="Fundamental frequency [Hz]")
    create_histogram(npows, os.path.join(args.figure_dir,
                                         f"{spk}_npowhistogram.png"),
                     range_min=-70, range_max=20, step=10,
                     xlabel="Power [dB]")
    logging.info("histograms written to %s", args.figure_dir)


if __name__ == "__main__":
    main()
