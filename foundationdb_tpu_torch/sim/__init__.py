"""Machine-level simulation: simulated cluster + fault workloads + seed farm.

Reference: REF:fdbserver/SimulatedCluster.actor.cpp + workloads/ — the
whole-cluster crucible: machines with lossy filesystems and a shared
deterministic network get killed, rebooted, clogged and partitioned while
invariant workloads run; any divergence is a real bug at some seed.
"""

from .cluster_sim import RefreshingDatabase, SimMachine, SimulatedCluster

__all__ = ["SimMachine", "SimulatedCluster", "RefreshingDatabase"]
