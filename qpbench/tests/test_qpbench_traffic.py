"""The traffic generators: the same inputs for the same seed, others for
another, and the same work (lengths) for every seed."""

import json

import numpy as np

from qpbench import corpus
from qpbench.runners import decode, train
from qpbench.harness import ROOT

BIG = 2 ** 31 + 12_345   # seeds run past 32 signed bits


def load(kind, name):
    with open(ROOT / "qpbench" / kind / f"{name}.json") as f:
        return json.load(f)


def test_decode_round_seeded():
    cfg, tr = load("configs", "qpnet_default"), load("traffic", "decode_b20")
    tr = dict(tr, batches_per_round=2, batch=3, seconds=[0.05, 0.1])
    a = decode.make_round(cfg, tr, BIG, 0)
    b = decode.make_round(cfg, tr, BIG, 0)
    c = decode.make_round(cfg, tr, BIG + 1, 0)
    for x, y in zip(a, b):
        assert np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
        assert x[2:] == y[2:]
    assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a, c))
    # the same lengths for every seed, in batches sorted by length
    assert sorted(n for x in a for n in x[2]) == \
        sorted(n for x in c for n in x[2])
    for x in a:
        assert max(x[3]) - min(x[3]) <= (max(max(y[3]) for y in a)
                                         - min(min(y[3]) for y in a))
    by_length = sorted(a, key=lambda x: max(x[3]))
    assert [m for *_, m in by_length] == ["sampling", "argmax"]


def test_f0_reaches_the_speakers_lowest():
    g = corpus.rng(BIG, 1)
    for lo, hi in load("traffic", "decode_b20")["speaker_f0_hz"]:
        f0 = corpus.f0_track(g, 300, lo, hi)
        assert f0.min() == lo and f0.max() <= hi


def test_serve_streams_seeded_on_a_fixed_schedule():
    cfg, tr = load("configs", "qpnet_default"), load("traffic", "serve_c32")
    one = [corpus.serve_stream(cfg, tr, BIG, c, 0) for c in range(32)]
    again = [corpus.serve_stream(cfg, tr, BIG, c, 0) for c in range(32)]
    other = [corpus.serve_stream(cfg, tr, BIG + 1, c, 0) for c in range(32)]
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(one, again))
    assert not any(np.array_equal(a[0][0], b[0][0])
                   for a, b in zip(one, other))
    # every seed the same schedule: each client's length and reply delay
    assert [len(a[0]) for a in one] == [len(b[0]) for b in other]
    for turn in (0, 5):
        sched = [corpus.schedule(cfg, tr, c, turn) for c in range(32)]
        lens = sorted(f for f, _ in sched)
        assert lens == sorted(corpus.even_lengths(
            32, *tr["seconds"], cfg["upsampling_factor"]))
        lo, hi = tr["reply_delay_s"]
        delays = sorted(w for _, w in sched)
        assert lo < delays[0] and delays[-1] < hi
        assert len(set(delays)) == 32
    assert [corpus.schedule(cfg, tr, c, 0) for c in range(32)] != \
        [corpus.schedule(cfg, tr, c, 1) for c in range(32)]
    # maxd 32 holds every stream's dilation factors
    assert max(float(d.max()) for _, d in one) <= 32


def test_group_sizes_count_whole_groups_inside_the_window():
    from qpbench.runners.serve import group_sizes

    def rec(send, first, done):
        return {"t_send": send, "t_first": first, "t_done": done}
    recs = [rec(0.5, 2.0, 9.0), rec(0.6, 2.01, 9.0), rec(0.7, 2.02, 9.0),
            rec(3.0, 9.5, 12.0), rec(4.0, 9.51, 12.0),     # ends past 10
            rec(-1.0, 0.2, 1.5),                           # sent before 0
            rec(8.0, None, None)]
    assert group_sizes(recs, 0.0, 10.0) == [3]


def test_train_utterances_seeded():
    cfg, tr = load("configs", "qpnet_default"), load("traffic", "train_f32")
    tr = dict(tr, utterances=4, seconds=[0.1, 0.2])
    a, b = train.utterances(cfg, tr, BIG), train.utterances(cfg, tr, BIG)
    c = train.utterances(cfg, tr, BIG + 1)
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(a, b))
    assert not any(np.array_equal(x[1][:100], y[1][:100])
                   for x, y in zip(a, c))
    assert sorted(len(x[1]) for x in a) == sorted(len(x[1]) for x in c)


def test_delivered_counts_feeds_in_flight_by_their_share():
    from qpbench.runners.serve import delivered
    chunks = [(1.0, 100), (2.0, 100), (3.0, 50)]
    assert delivered(chunks, 0.5, 0.0, 10.0) == 250
    # the window ends half way through the second feed
    assert delivered(chunks, 0.5, 0.0, 1.5) == 150
    # and starts half way through the first (made over [0, 1])
    assert delivered(chunks, 0.5, 0.5, 10.0) == 200
    # continuous: a chunk a millisecond either side of the end moves little
    a = delivered(chunks, 0.5, 0.0, 1.999)
    b = delivered(chunks, 0.5, 0.0, 2.001)
    assert abs(a - b) < 1
