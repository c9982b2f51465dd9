"""Simulation workloads — invariant-checking test drivers.

Reference: REF:fdbserver/workloads/ (~100 TestWorkload classes driven by
.toml specs, REF:fdbserver/tester.actor.cpp).  Each workload has
setup/start/check phases; fault-injection workloads run concurrently with
functional ones, and check() asserts a database invariant that would be
violated by lost/phantom/reordered writes.
"""

from .workload import (TestWorkload, WorkloadContext, register_workload,
                       make_workload, run_workloads, run_workloads_on)
from . import (api_fuzz, attrition, change_feed,  # noqa: F401  (register)
               conflict_range, consistency, correctness, cycle, disk_fault,
               dynamic, increment, layers, ops, ops2, random_rw,
               serializability)
