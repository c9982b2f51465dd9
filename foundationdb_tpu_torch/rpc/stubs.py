"""Role RPC stubs: serve a role object over a transport + client proxies.

Reference: REF:fdbrpc/fdbrpc.h — a role interface struct is a bundle of
RequestStreams at consecutive tokens; a client holding the struct calls
typed endpoints.  Here each role instance owns a token block on its
transport; the client proxy mirrors the in-process role's async surface,
so pipeline code (commit proxy, Transaction) cannot tell a stub from a
local object — the property that let the reference run identical role
code in sim and production.
"""

from __future__ import annotations

import asyncio
from typing import Any

from ..core.data import KeyRange
from ..runtime.span import SpanSink, current_span
from .transport import Endpoint, NetworkAddress, Transport

# method table per role: (name, oneway?)
ROLE_METHODS: dict[str, list[tuple[str, bool]]] = {
    # metrics appended LAST: token layout is base+index, so
    # new methods must never reorder existing slots
    "sequencer": [("get_commit_version", False),
                  ("get_live_committed_version", False),
                  ("report_committed", True), ("lock", False),
                  ("report_lock", True), ("metrics", False)],
    "resolver": [("resolve", False), ("metrics", False)],
    "tlog": [("push", False), ("peek", False), ("pop", True),
             ("lock", False), ("metrics", False)],
    # change-feed methods appended at 713, get_values at 714,
    # shard_metrics with the shard-heat subsystem, get_key_values_packed
    # at 715, get_key at 716, scrub_page at 718 — always LAST: token
    # layout is base+index, so new methods must never reorder existing
    # slots
    "storage": [("get_value", False), ("get_key_values", False),
                ("watch_value", False), ("metrics", False),
                ("get_latest_range", False), ("sample_split_key", False),
                ("change_feed_stream", False), ("fetch_feed_state", False),
                ("get_values", False), ("shard_metrics", False),
                ("get_key_values_packed", False), ("get_key", False),
                ("scrub_page", False)],
    # metrics appended LAST: token layout is base+index, so new methods
    # must never reorder existing slots
    "commit_proxy": [("commit", False), ("metrics", False)],
    "grv_proxy": [("get_read_version", False), ("metrics", False)],
    # metrics appended LAST
    "ratekeeper": [("admit", False), ("get_rate", False),
                   ("get_throttle", False), ("set_tag_throttle", False),
                   ("metrics", False)],
    "coordinator": [("read", False), ("write", False),
                    ("nominate", False), ("confirm", False),
                    ("withdraw", False), ("leader_heartbeat", False),
                    ("open_database", False), ("read_leader", False),
                    ("move", False), ("get_forward", False)],
    # disk_health appended LAST: token layout is base+index,
    # so new methods must never reorder existing slots
    "worker": [("recruit", False), ("stop_role", False),
               ("rejoin_storage", False), ("list_roles", False),
               ("disk_health", False)],
    "cluster_controller": [("register_worker", False),
                           ("get_cluster_state", False)],
    "log_router": [("peek", False), ("pop", True), ("metrics", False)],
}

TOKEN_BLOCK = 16  # tokens reserved per role instance

# wire-level receive events for sampled requests: one per dispatched RPC,
# timestamping the server-side arrival of each hop so the trace analyzer
# can split client-observed latency into network/queue vs service time
_RPC_SPANS = SpanSink("rpc")


def serve_role(transport: Transport, role: str, obj: Any,
               base_token: int) -> None:
    """Register obj's role methods at base_token + method index, plus a
    role-liveness ping at the block's LAST token (base + TOKEN_BLOCK-1).
    The ping answers only while THIS role instance is registered — a
    process that crashed and was respawned by its supervisor answers
    address-level pings fine while its recruited role endpoints are
    gone; the cluster controller probes this slot to tell the two
    apart (the reference's waitFailureClient on role interfaces)."""
    for i, (name, _oneway) in enumerate(ROLE_METHODS[role]):
        method = getattr(obj, name)

        async def handler(args, method=method, loc=f"{role}.{name}"):
            ctx = current_span()
            if ctx is not None and ctx.sampled:
                _RPC_SPANS.event("RpcDebug", ctx, loc)
            result = method(*args)
            if asyncio.iscoroutine(result):
                result = await result
            return result
        transport.dispatcher.register(handler, token=base_token + i)

    async def role_ping(_args, role=role, obj=obj):
        # a fail-stopped role instance (resolver poison, proxy
        # unrepairable batch) must probe DEAD even though its process —
        # and this handler — are alive: the CC's role-liveness probe is
        # what converts the fail-stop into an epoch recovery
        if getattr(obj, "_failed", None) is not None \
                or getattr(obj, "_poisoned", None) is not None:
            from ..runtime.errors import EndpointNotFound
            raise EndpointNotFound()
        return role
    ping_token = base_token + TOKEN_BLOCK - 1
    # static layouts (worker block + CC surface sharing one block) may
    # overlap; the probe only targets RECRUITED role blocks, which are
    # always distinct
    if ping_token not in transport.dispatcher._handlers:
        transport.dispatcher.register(role_ping, token=ping_token)


class RoleClient:
    """Generic client proxy; subclasses pin the role name and add the
    static attributes pipeline code reads (shard, tag, key_range)."""

    role: str = ""

    def __init__(self, transport: Transport, address: NetworkAddress,
                 base_token: int) -> None:
        self._transport = transport
        self._address = address
        self._base = base_token
        for i, (name, oneway) in enumerate(ROLE_METHODS[self.role]):
            ep = Endpoint(address, base_token + i)
            if oneway:
                setattr(self, name, self._make_oneway(ep))
            else:
                setattr(self, name, self._make_call(ep))

    def _make_call(self, ep: Endpoint):
        async def call(*args):
            return await self._transport.request(ep, list(args))
        return call

    def _make_oneway(self, ep: Endpoint):
        def send(*args):
            self._transport.one_way(ep, list(args))
        return send


class SequencerClient(RoleClient):
    role = "sequencer"


class ResolverClient(RoleClient):
    role = "resolver"

    def __init__(self, transport, address, base_token, key_range: KeyRange):
        super().__init__(transport, address, base_token)
        self.key_range = key_range


class TLogClient(RoleClient):
    role = "tlog"


class StorageClient(RoleClient):
    role = "storage"

    def __init__(self, transport, address, base_token, tag: int,
                 shard: KeyRange):
        super().__init__(transport, address, base_token)
        self.tag = tag
        self.shard = shard


class CommitProxyClient(RoleClient):
    role = "commit_proxy"


class RatekeeperClient(RoleClient):
    role = "ratekeeper"


class ClusterControllerClient(RoleClient):
    role = "cluster_controller"


class GrvProxyClient(RoleClient):
    role = "grv_proxy"


class CoordinatorClient(RoleClient):
    role = "coordinator"


def make_coordinator_stubs(addrs, transport=None, transport_factory=None,
                           token=None):
    """Build CoordinatorClients from wire-shaped ([ip, port]) or
    NetworkAddress addresses — the ONE home of the address normalization
    every quorum-change site needs.  Pass either a shared ``transport``
    or a per-stub ``transport_factory``."""
    from .transport import WLTOKEN_COORDINATOR, NetworkAddress
    token = WLTOKEN_COORDINATOR if token is None else token
    out = []
    for a in addrs:
        na = NetworkAddress(a[0], a[1]) if isinstance(a, (list, tuple)) else a
        t = transport if transport is not None else transport_factory()
        out.append(CoordinatorClient(t, na, token))
    return out


class LogRouterClient(RoleClient):
    role = "log_router"


class WorkerClient(RoleClient):
    role = "worker"
