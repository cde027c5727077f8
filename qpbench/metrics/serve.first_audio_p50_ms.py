"""Time to first audio at the median (nearest rank) of the same streams
as first_audio_p90_ms (host clock)."""

import math


def read(run):
    waits = run.counts.get("first_audio_ms")
    if not waits:
        return None
    return sorted(waits)[math.ceil(0.5 * len(waits)) - 1]
