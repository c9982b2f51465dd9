"""A traced slice of the loop under ``torch.profiler``, reduced to what
the per-layer metrics and the result's ``breakdown`` read.

The slice runs after the measured window with the profiler on (CPU
activity and, on a card, CUDA activity): ``trace_groups`` groups in
steady state, with ``inflight`` more on each side to fill and drain the
pipeline.  Its window runs from the hand-off of the first steady group
(its ``kvbench.enqueue`` span) to the end of the wait for the last
(its ``kvbench.wait`` span), so the loop holds ``inflight`` groups all
through it.  Inside that window the device is busy where some kernel,
copy or memset runs (the union of their intervals); an idle gap is
named by what the host was doing at its middle: the harness's own span
(``kvbench.enqueue``, ``kvbench.wait``) and the innermost host
operation inside it.
"""

from __future__ import annotations

import dataclasses

ENQUEUE, WAIT = "kvbench.enqueue", "kvbench.wait"


@dataclasses.dataclass
class Trace:
    groups: list                    # loop.Group of the slice, in order
    window_s: float                 # the steady window, profiler's clock
    busy_s: float                   # device busy time inside it
    device_ops: list                # [(name, seconds)], most first
    idle_gaps: list                 # [(name, seconds)], longest first
    # every kernel launch of the slice in device order:
    # (short name, seconds, wholly inside the steady window)
    launches: list


def _short(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces or its
    argument list: ``hist_check_kernel<true>``."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0] or name


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(events, groups: list, skip: int, steady: int,
           top: int = 10) -> Trace:
    """Reduce profiler events (``prof.events()``: times in microseconds)
    over the steady window: from the hand-off of group ``skip`` to the
    end of the wait for group ``skip + steady - 1``."""
    from torch.autograd import DeviceType

    spans = {ENQUEUE: [], WAIT: []}
    dev, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a host annotation mirrored on the device's timeline is no
            # device work
            if not getattr(e, "is_user_annotation", False) \
                    and not e.name.startswith("kvbench."):
                dev.append((e.name, a, b))
        else:
            if e.name in spans:
                spans[e.name].append((a, b))
            host.append((e.name, a, b))
    enq, wait = sorted(spans[ENQUEUE]), sorted(spans[WAIT])
    if len(enq) < skip + steady or len(wait) < skip + steady:
        raise RuntimeError(f"the trace holds {len(enq)} hand-offs and "
                           f"{len(wait)} waits, not {skip + steady}")
    w0, w1 = enq[skip][0], wait[skip + steady - 1][1]
    dev.sort(key=lambda d: d[1])
    launches = [(_short(n), (b - a) * 1e-6, w0 <= a and b <= w1)
                for n, a, b in dev]
    dev = [(n, max(a, w0), min(b, w1)) for n, a, b in dev]
    dev = [d for d in dev if d[2] > d[1]]
    busy = union([(a, b) for _, a, b in dev])
    busy_us = sum(b - a for a, b in busy)
    per_op: dict[str, float] = {}
    for name, a, b in dev:
        per_op[_short(name)] = per_op.get(_short(name), 0.0) + (b - a)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])

    def doing(t: float) -> str:
        at = [(b - a, name) for name, a, b in host if a <= t <= b]
        named = [n for _, n in sorted(at, reverse=True)
                 if n.startswith("kvbench.")]
        inner = min(at)[1] if at else "idle host"
        return " > ".join(([named[-1]] if named else [])
                          + ([inner] if inner not in named else []))

    return Trace(
        groups=groups, window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
        device_ops=sorted(((n, s * 1e-6) for n, s in per_op.items()),
                          key=lambda x: -x[1])[:top],
        idle_gaps=[(doing((a + b) / 2), (b - a) * 1e-6)
                   for a, b in gaps[:top]],
        launches=launches)


def run(loop, groups: int, sync) -> Trace:
    """``groups`` steady groups of ``loop`` under the profiler, with
    ``loop.inflight`` groups before them to fill the pipeline and as
    many after them to keep it full to the last one's end."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    skip = loop.inflight
    sync()
    with profile(activities=acts) as prof:
        done, _, _ = loop.run(groups=groups + 2 * skip, span=record_function)
        sync()
    return reduce(prof.events(), done, skip, groups)
