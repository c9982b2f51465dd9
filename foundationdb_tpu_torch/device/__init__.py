"""Device-resident subsystems.

``pipeline`` — the resolver's device commit pipeline: persistent
               on-device ConflictState, host-side batch queueing, fused
               pipelined dispatch.
"""
