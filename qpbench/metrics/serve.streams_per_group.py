"""Streams a group over the groups that the service started and finished
inside the window (client clock: a group's streams get their first audio
from one feed)."""


def read(run):
    sizes = run.counts.get("serve_group_sizes")
    return sum(sizes) / len(sizes) if sizes else None
