"""Device-resident subsystems.

``pipeline``   — the resolver's device commit pipeline: persistent
                 on-device ConflictState, host-side batch queueing, fused
                 pipelined dispatch.
``read_serve`` — device gather path for point-read serving: a mirror of
                 the storage engine's PackedKeyIndex key prefixes served
                 by one ``prefix_search`` kernel launch per batch.
"""
