"""One run of one cell: set-up, the measured window, the traced slice,
the check against the reference, and the result's line.

``run`` takes the device it is given (the CUDA card from ``kvbench.run``;
the CPU in the tests, where the port's kernels run their plain
versions) and returns a ``Run``, whose ``result`` is the JSON object the
benchmark prints last.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from pathlib import Path

import numpy as np

from . import reference, spec, stats
from . import stream as stream_mod
from . import trace as trace_mod

# every number compared, each with its limit: verdicts are exact, so
# each limit is 0
LIMITS = {
    "false_conflicts": 0,       # program aborted, reference committed
    "missed_conflicts": 0,      # program committed, reference aborted
    "wrong_codes": 0,           # both aborted, for different reasons
    "batches_missing": 0,       # a batch of the window without verdicts
}


@dataclasses.dataclass
class Counters:
    """The backend's own counters, and the out-of-band dictionary
    shipments the harness counts around the conflict set's
    ``apply_dict_updates``."""
    dict_dispatches: int = 0
    dict_fallbacks: int = 0
    dict_out_of_band: int = 0

    def minus(self, other: "Counters") -> "Counters":
        return Counters(*(getattr(self, f.name) - getattr(other, f.name)
                          for f in dataclasses.fields(self)))


class GcClock:
    """Collections of Python's garbage collector and the seconds they
    took, while registered (``gc.callbacks``)."""

    def __init__(self) -> None:
        self.collections = 0
        self.seconds = 0.0
        self._t = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.collections += 1
            self.seconds += time.perf_counter() - self._t


@dataclasses.dataclass
class Run:
    cell: dict
    config: dict
    mix: dict
    stream: stream_mod.Stream
    device_name: str
    setup_s: float
    groups: list                # loop.Group of the measured window
    window_s: float
    counters: Counters          # over the window
    ring: dict                  # the conflict set's capacity and window
    trace: trace_mod.Trace | None
    checks: dict                # LIMITS' numbers, committed, compared
    memory_peak_bytes: int
    gc_window: GcClock | None = None    # the collector inside the window
    ref: np.ndarray | None = None   # the reference's verdicts of a pass
    result: dict = dataclasses.field(default_factory=dict)

    @property
    def batches(self) -> int:
        return len(self.groups) * self.mix["group_batches"]

    @property
    def txns(self) -> int:
        return self.batches * self.stream.txns

    def latencies_s(self) -> np.ndarray:
        """Every batch's time from its group's hand-off to its verdicts
        on the host."""
        lat = np.array([g.t_done - g.t_sub for g in self.groups])
        return np.repeat(lat, self.mix["group_batches"])


def _counters(backend, probe: Counters) -> Counters:
    return Counters(getattr(backend, "dict_dispatches", 0),
                    getattr(backend, "dict_fallbacks", 0),
                    probe.dict_out_of_band)


def _probe(backend) -> Counters:
    """Count the conflict set's out-of-band dictionary shipments (a
    group whose new endpoints did not fit the fused upload)."""
    probe = Counters()
    cs = backend.cs
    inner = cs.apply_dict_updates

    def counted(*args, **kwargs):
        probe.dict_out_of_band += 1
        return inner(*args, **kwargs)

    cs.apply_dict_updates = counted
    return probe


def compare(groups: list, ref: np.ndarray, group: int) -> dict:
    """Every verdict of every group against the reference's for its
    place in the pass; the counts of ``LIMITS`` and of committed txns.
    A batch without verdicts (-1, or a group that never came back) is
    missing."""
    out = dict.fromkeys(LIMITS, 0)
    out["committed"] = 0
    out["batches_compared"] = 0
    for g in groups:
        want = ref[g.pos * group:(g.pos + 1) * group]
        if g.verdicts is None:
            out["batches_missing"] += group
            continue
        got = g.verdicts.astype(np.int64)
        here = (got >= 0).all(axis=1)
        out["batches_missing"] += int((~here).sum())
        v, w = got[here], want[here]
        out["false_conflicts"] += int(((w == 0) & (v != 0)).sum())
        out["missed_conflicts"] += int(((w != 0) & (v == 0)).sum())
        out["wrong_codes"] += int(((w != 0) & (v != 0) & (v != w)).sum())
        out["committed"] += int((v == 0).sum())
        out["batches_compared"] += v.shape[0]
    return out


def _sync(device):
    import torch
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def run(bench: dict, cell: dict, seed: int, seconds: float, traced: bool,
        device, t_start: float, root: Path = spec.ROOT,
        backend_hook=None, knobs: dict | None = None) -> Run:
    """One run.  ``backend_hook(backend)``, when given, may wrap the
    backend the window drives (the tests plant faults with it);
    ``knobs`` override the configuration's (the control's narrower key
    encoding)."""
    import torch
    from foundationdb_tpu_torch.ops.backends import make_conflict_backend
    from foundationdb_tpu_torch.ops.batch import WireBatch
    from foundationdb_tpu_torch.runtime.knobs import Knobs

    from .loop import Loop

    cfg = spec.config(bench, cell["config"], root)
    mix = spec.traffic(cell["traffic"], root)
    stream = stream_mod.build(cfg, mix, seed, root)
    wires = [WireBatch(*stream.wire(j), stream.txns)
             for j in range(stream.n_batches)]
    backend = make_conflict_backend(
        Knobs().override(**{**cfg["knobs"], **(knobs or {})}), device=device)
    probe = _probe(backend)
    driven = backend_hook(backend) if backend_hook else backend
    loop = Loop(driven, wires, stream.versions, mix["group_batches"],
                mix["inflight_groups"])
    sync = _sync(device)

    # set-up: warm passes build the kernels, fill the endpoint
    # dictionary as a long-lived resolver holds it, and use every shape
    # the window uses
    loop.run(groups=mix["warm_passes"] * loop.per_pass)
    sync()
    ring = {"capacity": backend.cs.capacity, "window": backend.cs.window}
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    c0 = _counters(backend, probe)
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    try:
        groups, t0, t1 = loop.run(seconds=seconds)
    finally:
        gc.callbacks.remove(gc_clock)
    counters = _counters(backend, probe).minus(c0)
    tr = trace_mod.run(loop, mix["trace_groups"], sync) if traced else None
    cuda = device.type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    name = torch.cuda.get_device_name(device) if cuda else "cpu"

    # the program's state goes before the reference runs
    del loop, driven, backend
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference.resolve_stream(stream, cfg["mvcc_window_versions"])
    checked = compare(groups + (tr.groups if tr else []), ref,
                      mix["group_batches"])
    out = Run(cell=cell, config=cfg, mix=mix, stream=stream,
              device_name=name, setup_s=setup_s, groups=groups,
              window_s=t1 - t0, counters=counters, ring=ring, trace=tr,
              checks=checked, memory_peak_bytes=peak, gc_window=gc_clock,
              ref=ref)
    out.result = result(bench, out, traced, root)
    return out


def _metrics(bench: dict, run: Run, kind: str, root: Path) -> dict:
    out = {}
    for m in spec.metrics(bench, run.cell["name"], kind):
        value = spec.module("metrics", m["name"], root).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(bench: dict, run: Run, traced: bool, root: Path) -> dict:
    correct = run.checks["batches_compared"] > 0 and all(
        run.checks[k] <= lim for k, lim in LIMITS.items())
    missing = run.checks["batches_missing"]
    device = {"platform": "gpu" if run.device_name != "cpu" else "cpu",
              "kind": run.device_name, "count": run.cell["chips"],
              "memory_peak_bytes": run.memory_peak_bytes}
    res = {"correct": bool(correct), "attempted": run.txns,
           "failed": missing * run.stream.txns,
           "metrics": _metrics(bench, run,
                               "per_layer" if traced else "end_to_end",
                               root),
           "device": device}
    if traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        res["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps]}
    res["checks"] = {k: {"value": run.checks[k], "limit": lim}
                     for k, lim in LIMITS.items()}
    return res


def samples(run: Run) -> dict:
    """What the window's statistics stand on (for standard error)."""
    return {"batches": run.batches, "groups": len(run.groups),
            "txns": run.txns, "window_s": run.window_s,
            "latency_ms": stats.latency_ms(list(run.latencies_s()),
                                           (50, 95, 99)),
            "traced_groups": len(run.trace.groups) if run.trace else 0,
            "gc_in_window": vars(run.gc_window) if run.gc_window else None}


def print_checks(run: Run, file=sys.stderr) -> None:
    """Each number compared beside its limit, as the last lines."""
    for k, lim in LIMITS.items():
        print(f"check {k} {run.checks[k]} limit {lim}", file=file,
              flush=True)
