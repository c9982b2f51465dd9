"""Numbered error system, mirroring FDB's error model.

Reference: REF:flow/Error.h, REF:flow/error_definitions.h — FDB errors are
small numbered values thrown through futures; clients switch on the code in
``Transaction::onError`` to decide retry behavior.  We keep the same codes for
the errors we implement so FDB users find familiar numbers.
"""

from __future__ import annotations


class FdbError(Exception):
    """An error with an FDB-compatible numeric code."""

    code: int = 0
    name: str = "unknown_error"

    def __init__(self, *args):
        super().__init__(*args or (self.name,))

    # --- retry classification (mirrors fdb_error_predicate in REF:bindings/c) ---
    @property
    def retryable(self) -> bool:
        return self.code in _RETRYABLE

    @property
    def maybe_committed(self) -> bool:
        return self.code in _MAYBE_COMMITTED


_REGISTRY: dict[int, type[FdbError]] = {}


def _err(code: int, name: str, doc: str) -> type[FdbError]:
    cls = type(name, (FdbError,), {"code": code, "name": name, "__doc__": doc})
    _REGISTRY[code] = cls
    return cls


def error_from_code(code: int) -> FdbError:
    cls = _REGISTRY.get(code)
    if cls is None:
        e = FdbError(f"error code {code}")
        e.code = code
        return e
    return cls()


# Codes match upstream flow/error_definitions.h where an equivalent exists.
OperationFailed = _err(1000, "operation_failed", "Operation failed")
TimedOut = _err(1004, "timed_out", "Operation timed out")
TransactionTooOld = _err(1007, "transaction_too_old", "Read version is too old to be satisfied")
FutureVersion = _err(1009, "future_version", "Request for a future version")
NotCommitted = _err(1020, "not_committed", "Transaction not committed due to a conflict")
CommitUnknownResult = _err(1021, "commit_unknown_result", "Commit result unknown")
TransactionCancelled = _err(1025, "transaction_cancelled", "Transaction was cancelled")
ConnectionFailed = _err(1026, "connection_failed", "Network connection failed")
TransactionTimedOut = _err(1031, "transaction_timed_out", "Transaction timed out")
TLogStopped = _err(1011, "tlog_stopped", "TLog stopped (generation locked by recovery)")
EndpointNotFound = _err(1012, "endpoint_not_found", "Endpoint not found (role gone or fail-stopped)")
ProcessBehind = _err(1037, "process_behind", "Storage process does not have recent mutations")
DatabaseLocked = _err(1038, "database_locked", "Database is locked")
ClusterVersionChanged = _err(1039, "cluster_version_changed", "Cluster has been upgraded to a new protocol version")
BrokenPromise = _err(1100, "broken_promise", "The promise was never set or was dropped")
OperationCancelled = _err(1101, "operation_cancelled", "Asynchronous operation cancelled")
IoError = _err(1510, "io_error", "Disk i/o operation failed")
DiskCorrupt = _err(1512, "disk_corrupt",
                   "Committed on-disk data failed its checksum — NOT a "
                   "torn tail: recovery must fail loudly, never silently "
                   "truncate acked data (upstream's file_corrupt; its "
                   "exact code was unverifiable this session, 1512 "
                   "reserved here)")
PlatformError = _err(1500, "platform_error", "Platform error")
ClientInvalidOperation = _err(2000, "client_invalid_operation", "Invalid API call")
KeyOutsideLegalRange = _err(2003, "key_outside_legal_range", "Key outside legal range")
InvertedRange = _err(2005, "inverted_range", "Range begin key exceeds end key")
InvalidOption = _err(2007, "invalid_option", "Option not valid in this context")
VersionInvalid = _err(2011, "version_invalid", "Version not valid")
TransactionReadOnly = _err(2023, "transaction_read_only", "Transaction is read-only and cannot be committed")
UsedDuringCommit = _err(2017, "used_during_commit", "Operation issued while a commit was outstanding")
KeyTooLarge = _err(2102, "key_too_large", "Key length exceeds limit")
ValueTooLarge = _err(2103, "value_too_large", "Value length exceeds limit")
TransactionTooLarge = _err(2101, "transaction_too_large", "Transaction exceeds byte limit")

WrongShardServer = _err(1001, "wrong_shard_server",
                        "Shard is no longer served by this storage server "
                        "(client must refresh its location map and retry); "
                        "upstream's exact code was unverifiable this session "
                        "— 1001 is reserved here for it")
RequestMaybeDelivered = _err(1213, "request_maybe_delivered",
                             "Request may or may not have been delivered")

CoordinatorsChanged = _err(1101 + 100, "coordinators_changed",
                           "The coordinator set has changed; refetch the "
                           "connection string and retry (upstream's "
                           "coordinators_changed — its exact code was "
                           "unverifiable this session, 1201 reserved here)")

# resolver-internal (ours; no upstream equivalent needed on the wire)
ResolverCapacityExceeded = _err(2900, "resolver_capacity_exceeded",
                                "Conflict-set history ring overflowed; txn forced too-old")
ResolverFailed = _err(2901, "resolver_failed",
                      "Resolver backend failed after history mutation; "
                      "role is fail-stopped pending recovery")
LogDataLoss = _err(2902, "log_data_loss",
                   "Every replica of a log tag is gone; recovery impossible")

# change feeds (upstream's exact codes were unverifiable this session;
# the 2903/2904 block is reserved here for them)
ChangeFeedNotRegistered = _err(2903, "change_feed_not_registered",
                               "No such change feed on this storage server "
                               "(never registered, destroyed, or the range "
                               "moved — consumers refresh and retry briefly)")
ChangeFeedPopped = _err(2904, "change_feed_popped",
                        "Requested change-feed data was released by a pop "
                        "(cursor is below the durable low-water mark)")
ChangeFeedDestroyed = _err(2905, "feed_destroyed",
                           "The change feed's registration row is gone: it "
                           "was destroyed while a cursor was draining it.  "
                           "Unlike change_feed_not_registered (a transient "
                           "handoff race the cursor retries through), this "
                           "is a definite terminal outcome — the retained "
                           "segments were released at the destroy version "
                           "and no retry can recover them.  NOT retryable "
                           "(upstream's change_feed_cancelled analog; its "
                           "exact code was unverifiable this session, 2905 "
                           "reserved here)")

# 1213 is retryable for idempotent operations (reads, GRV); the commit
# path converts it to commit_unknown_result (1021) before the client's
# retry loop can see it, because re-running a maybe-delivered commit is
# not idempotent.
# 1510 (io_error) is retryable HERE unlike upstream (where it kills the
# process): with the sim injecting transient per-op disk errors
#, every consumer's existing retry loop absorbs them instead
# of fail-stopping a role per glitch.  1512 (disk_corrupt) is NOT —
# corruption of committed data must surface loudly, never be retried
# into silence.
_RETRYABLE = {1001, 1004, 1007, 1009, 1012, 1020, 1021, 1026, 1031, 1037,
              1039, 1191, 1201, 1213, 1510, 2900}
# 1031 is maybe-committed like upstream: a commit cut off by the
# transaction deadline may already
# have been delivered — callers consulting e.maybe_committed must not
# treat the write as definitely absent.
_MAYBE_COMMITTED = {1021, 1031}
