"""What the readers of the program's own spans share.

The program (faucet_tpu_torch/metrics.py) times each span under its path,
the names of the enclosing spans and its own joined by "/"
("build/pass1/walk/round"), in Metrics.timers, where a path's seconds
include its children's; while torch.profiler records, the span is also a
host event named "faucet." + its path. ctx["assemblies"] holds each
assembly's timers (the profiled one left out), ctx["slices"] the profiled
slices, whose host events hold the spans. A program without these spans
leaves the readers nothing to read: they return None.
"""
from __future__ import annotations

PREFIX = "faucet."  # the program's spans in the profiler's host events


def self_s(timers: dict, path: str):
    """Seconds of span `path` less those of its direct children."""
    if path not in timers:
        return None
    kids = sum(v for k, v in timers.items() if k.startswith(path + "/")
               and "/" not in k[len(path) + 1:])
    return timers[path] - kids


def ending(timers: dict, tail: str):
    """Summed seconds of every path that ends in `tail` ("walk/resolve":
    the walks of both passes), or None when there is none."""
    vals = [v for k, v in timers.items()
            if k == tail or k.endswith("/" + tail)]
    return sum(vals) if vals else None


def per_assembly(ctx: dict, fn):
    """Mean of fn(timers) over ctx's assemblies; None when fn finds
    nothing in one of them."""
    vals = [fn(t) for t in ctx.get("assemblies") or []]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)


def step_events(ctx: dict):
    """The profiled slices' span events inside stream steps, as (seconds,
    the path's names from the stream step's child on), and the number of
    stream steps."""
    events, steps = [], 0
    for sl in (ctx.get("slices") or {}).values():
        for s, e, name in sl.host:
            if not name.startswith(PREFIX):
                continue
            names = name[len(PREFIX):].split("/")
            if names[-1] == "stream_step":
                steps += 1
            elif "stream_step" in names:
                i = names.index("stream_step")
                events.append(((e - s) / 1e9, names[i + 1:]))
    return events, steps


def per_step(ctx: dict, fn):
    """fn(events) over the number of stream steps, or None when the
    slices hold no stream step."""
    events, steps = step_events(ctx)
    return fn(events) / steps if steps else None
