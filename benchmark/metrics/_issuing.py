"""Host time per stream batch in some of the program's spans, less the
blocking reads inside them: what the node and spool readers share."""
from __future__ import annotations

from benchmark.metrics import _spans


def ms_per_step(ctx: dict, leaves) -> float:
    """Milliseconds per stream step of the profiled slices in the spans
    named in `leaves`, less the `sync` spans at any depth below them;
    None when the slices hold no such span."""
    events, steps = _spans.step_events(ctx)
    whole = [s for s, names in events if names[-1] in leaves]
    if not whole or not steps:
        return None
    waits = sum(s for s, names in events if names[-1] == "sync"
                and any(n in leaves for n in names[:-1]))
    return 1e3 * (sum(whole) - waits) / steps
