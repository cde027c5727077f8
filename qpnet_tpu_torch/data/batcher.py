"""Streaming training-window batcher, a copy of the JAX package's
`qpnet_tpu/data/batcher.py` with its windowing split from its file reads.

Utterances are concatenated into one continuous stream; each emitted window
carries its own receptive-field history; the window length self-adjusts so
`receptive_field + batch_length <= max_length` and the total is a multiple
of the upsampling factor.  Every batch is left-padded to one static shape
(`padded_shape(max_length, up)` samples; pad values x = mid-scale, h = 0,
d = 1 lie outside the loss region's receptive field).

`window_batches` is the windowing over in-memory `(fs, x, h)` utterances;
`train_window_generator` reads the wav/h5 pairs of two lists and feeds it,
so its batches are the JAX package's bit for bit, shuffle included.
"""

from __future__ import annotations

import queue
import threading
from typing import (Callable, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.data.lists import check_filenames
from qpnet_tpu_torch.ops import (batch_f0, dilated_factor, encode_mu_law,
                                 extend_time)
from qpnet_tpu_torch.utils import profiler


class BackgroundGenerator(threading.Thread):
    """Prefetch a generator in a daemon thread.  Worker exceptions are
    captured and re-raised from next()."""

    def __init__(self, generator, max_prefetch: int = 2):
        super().__init__(daemon=True)
        self.queue: "queue.Queue" = queue.Queue(max_prefetch)
        self.generator = generator
        self._error = None
        self.start()

    def run(self):
        try:
            for item in self.generator:
                self.queue.put(item)
        except BaseException as e:  # noqa: BLE001 - includes SystemExit
            self._error = e
        finally:
            self.queue.put(None)

    def next(self):
        item = self.queue.get()
        if item is None:
            if self._error is not None:
                raise RuntimeError(
                    "data pipeline worker failed") from self._error
            raise StopIteration
        return item

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self


def background(max_prefetch: int = 2):
    def decorator(fn):
        def wrapped(*args, **kwargs):
            return BackgroundGenerator(fn(*args, **kwargs), max_prefetch)
        return wrapped
    return decorator


def padded_shape(max_length: int, upsampling_factor: int) -> int:
    """Smallest multiple of `upsampling_factor` >= max_length: the one
    window length every training batch is padded to."""
    return -(-max_length // upsampling_factor) * upsampling_factor


def validate_length(x: np.ndarray, h: np.ndarray, up: int):
    """Trim a wav/feature pair to consistent lengths."""
    if x.shape[0] > h.shape[0] * up:
        x = x[: h.shape[0] * up]
    if x.shape[0] < h.shape[0] * up:
        mod_y = h.shape[0] * up - x.shape[0]
        mod_y_frame = mod_y // up + 1
        h = h[:-mod_y_frame]
        x = x[: h.shape[0] * up]
    assert len(x) == len(h) * up
    return x, h


def utterance_stream(items: Sequence, load: Callable, shuffle: bool = True,
                     seed: int = 1, loop: bool = True) -> Iterator:
    """load(item) for each item, in an order drawn from
    np.random.default_rng(seed) (re-drawn each pass), once or forever."""
    rng = np.random.default_rng(seed)
    items = list(items)

    def order():
        if not shuffle:
            return items
        return [items[i] for i in rng.permutation(len(items))]

    while True:
        for item in order():
            yield load(item)
        if not loop:
            return


def window_batches(
        utterances: Iterable[Tuple[int, np.ndarray, np.ndarray]],
        cfg: ModelConfig,
        feat_transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        batch_length: int = 20000,
        batch_size: int = 1,
        max_length: int = 30000,
        f0_threshold: float = 0.0) -> Iterator[dict]:
    """Windows of a stream of (fs, x float32 in [-1, 1], h raw features)
    utterances, as static-shape batches:
      {"x": (B, Tp) i32, "h": (B, Tp/up, A) f32, "t": (B, Tp) i32,
       "d": (B, Tp) f32, "valid_len": i32 scalar, "window_lens": (B,) i32}
    where Tp = padded_shape(max_length, up).  d comes from the raw features'
    F0 column; `feat_transform` (the scaler) applies to h only.  The time
    from resuming to each yield, reading the utterances included, is the
    span batch.window (on the thread that iterates: `background`'s).
    """
    up = cfg.upsampling_factor
    dense = cfg.dense_factor
    Tp = padded_shape(max_length, up)
    Fp = Tp // up
    x_buffer = np.empty((0,), np.float32)
    h_buffer: Optional[np.ndarray] = None
    d_buffer = np.empty((0,), np.float64)
    batch: List[tuple] = []
    window = profiler.begin("batch.window")
    for fs, x, h in utterances:
        x, h = validate_length(x, h, up)
        d = dilated_factor(batch_f0(h, f0_threshold), fs, dense)
        d = np.squeeze(extend_time(np.expand_dims(d, -1), up), -1)
        if h_buffer is None:
            h_buffer = np.empty((0, h.shape[1]), np.float32)
        x_buffer = np.concatenate([x_buffer, x])
        h_buffer = np.concatenate([h_buffer, h])
        d_buffer = np.concatenate([d_buffer, d])

        receptive_field = cfg.receptive_field(float(np.nanmax(d_buffer)))
        # shrink the window to fit max_length and the upsampling ratio
        bl = batch_length - max(receptive_field + batch_length - max_length, 0)
        bl -= (receptive_field + bl) % up
        if bl <= 0:
            raise ValueError(
                f"max_length={max_length} cannot fit the receptive field "
                f"{receptive_field} plus any window; raise max_length or "
                f"f0_threshold (lowest F0 drives the receptive field)")
        h_bs = (receptive_field + bl) // up
        x_bs = h_bs * up + 1
        # carve as many windows as the buffer supports for the free slots
        while (len(h_buffer) > (batch_size - len(batch)) * h_bs
               and len(x_buffer) > (batch_size - len(batch)) * x_bs):
            h_ = h_buffer[:h_bs]
            x_ = x_buffer[:x_bs]
            d_ = d_buffer[:x_bs]
            if feat_transform is not None:
                h_ = feat_transform(h_)
            xq = encode_mu_law(x_, cfg.n_quantize)
            # window: input xq[:-1], target xq[1:], both length h_bs*up
            T = h_bs * up
            x_in = np.full((Tp,), cfg.n_quantize // 2, np.int32)
            tgt = np.full((Tp,), cfg.n_quantize // 2, np.int32)
            h_pad = np.zeros((Fp, h_.shape[1]), np.float32)
            d_pad = np.ones((Tp,), np.float32)
            x_in[Tp - T:] = xq[:-1]
            tgt[Tp - T:] = xq[1:]
            h_pad[Fp - h_bs:] = h_
            d_pad[Tp - T:] = d_[:-1]
            batch.append((x_in, h_pad, tgt, d_pad, bl))
            # slide
            h_ss = bl // up
            x_ss = h_ss * up
            h_buffer = h_buffer[h_ss:]
            x_buffer = x_buffer[x_ss:]
            d_buffer = d_buffer[x_ss:]
            if len(batch) == batch_size:
                bls = [b[4] for b in batch]
                # every window of a batch shares valid_len: the minimum
                out = {
                    "x": np.stack([b[0] for b in batch]),
                    "h": np.stack([b[1] for b in batch]),
                    "t": np.stack([b[2] for b in batch]),
                    "d": np.stack([b[3] for b in batch]),
                    "valid_len": np.int32(min(bls)),
                    # per-row pre-truncation lengths (diagnostic; the
                    # trainer drops this before the device step)
                    "window_lens": np.asarray(bls, np.int32),
                }
                profiler.end(window)
                yield out
                window = profiler.begin("batch.window")
                batch = []


def read_pair(feature_type: str = "world"):
    """load() of a (wav, h5) path pair -> (fs, x in [-1, 1], h)."""
    from scipy.io import wavfile

    from qpnet_tpu_torch.data.h5io import read_hdf5

    def load(pair):
        wavf, featf = pair
        assert check_filenames([wavf, featf])
        fs, x = wavfile.read(wavf)
        x = np.asarray(x, np.float32) / 32768
        return fs, x, read_hdf5(featf, f"/{feature_type}")
    return load


def train_window_generator(
        wav_list: Sequence[str],
        feat_list: Sequence[str],
        cfg: ModelConfig,
        feat_transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        feature_type: str = "world",
        batch_length: int = 20000,
        batch_size: int = 1,
        max_length: int = 30000,
        f0_threshold: float = 0.0,
        shuffle: bool = True,
        seed: int = 1,
        loop: bool = True) -> Iterator[dict]:
    """`window_batches` over the wav/h5 pairs of two lists (see there)."""
    pairs = list(zip(wav_list, feat_list))
    return window_batches(
        utterance_stream(pairs, read_pair(feature_type), shuffle, seed, loop),
        cfg, feat_transform, batch_length, batch_size, max_length,
        f0_threshold)
