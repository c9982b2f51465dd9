"""Core transaction-pipeline roles and data types.

The analog of REF:fdbserver/ — sequencer (master), GRV proxy, commit
proxy, resolver, TLog, storage server — plus the shared data types from
REF:fdbclient/CommitTransaction.h and REF:flow/Arena.h (KeyRangeRef,
MutationRef).  Roles are plain asyncio coroutines over the L0 runtime so
the same code runs under real time or the deterministic simulator.
"""

from .data import (
    KeyRange,
    KeySelector,
    Mutation,
    MutationType,
    key_after,
    strinc,
)
