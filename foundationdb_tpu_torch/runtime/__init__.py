"""L0 runtime: the Flow-analog layer (REF:flow/)."""

from .errors import FdbError, error_from_code
from .knobs import Knobs, KNOBS, set_global_knobs
from .rng import DeterministicRandom, deterministic_random, set_deterministic_random
from .simloop import SimEventLoop, SimQuiescenceError, run_simulation
from .trace import TraceEvent, TraceLog, Severity, Counter, CounterCollection, set_trace_log, get_trace_log
from .buggify import buggify, enable_buggify, buggify_enabled
from .actors import (Promise, PromiseStream, ActorCollection, wait_for_all,
                     timeout_error, delay, now)

__all__ = [
    "FdbError", "error_from_code", "Knobs", "KNOBS", "set_global_knobs",
    "DeterministicRandom", "deterministic_random", "set_deterministic_random",
    "SimEventLoop", "SimQuiescenceError", "run_simulation",
    "TraceEvent", "TraceLog", "Severity", "Counter", "CounterCollection",
    "set_trace_log", "get_trace_log",
    "buggify", "enable_buggify", "buggify_enabled",
    "Promise", "PromiseStream", "ActorCollection", "wait_for_all",
    "timeout_error", "delay", "now",
]
