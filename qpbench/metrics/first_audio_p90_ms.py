"""Time to first audio at the 90th percentile (nearest rank) of every
stream sent in the window, from the client's send to its first PCM bytes;
a stream that never got them counts as infinitely late (host clock)."""

import math


def read(run):
    waits = run.counts.get("first_audio_ms")
    if not waits:
        return None
    return sorted(waits)[math.ceil(0.9 * len(waits)) - 1]
