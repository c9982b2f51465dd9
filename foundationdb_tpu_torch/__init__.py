"""foundationdb_tpu_torch — the PyTorch/CUDA port of foundationdb_tpu.

The JAX package beside it stays the reference; this package is fed the
same inputs and must give bit-identical verdicts and ring state.  It
imports ``torch`` and numpy and nothing of ``jax`` or
``foundationdb_tpu``: the jax-free modules it needs are its own copies.

Ported so far, the resolver's conflict-detection path, the in-process
commit path around it, and the multi-process cluster:
  runtime/   event loop, sim, knobs, trace, errors, RNG (copies)
  ops/       key encoding, batch format, the conflict core on torch
             (conflict_torch), its hand kernels (kernels + csrc/*.cu),
             the backend registry, the C++ exact baseline
  device/    the resolver's device commit pipeline
  core/      the transaction roles of an in-process Cluster: sequencer,
             GRV and commit proxies, resolver, TLog, log system,
             storage server, ratekeeper; the shared data types; the
             multi-process roles (coordination, workers, the cluster
             controller and its recovery, data distribution, the
             scrubber, status)
  storage/   the MVCC window and the storage engines (copies)
  rpc/       the wire codec, the simulated and TCP transports, the role
             stubs, the failure monitor (copies)
  client/    Database / Transaction with read-your-writes, special keys,
             the tuple, subspace and directory layers (copies)
  server.py  one cluster process: ``python -m foundationdb_tpu_torch.server
             -C fdb.cluster -l IP:PORT [--device cuda|cpu]``
  native/    the C++ conflict set and key codec, built with g++ into
             _build/
  bench/     the mako workload generator, the end-to-end mako loop,
             the resolver profiles

Entry points run on the CUDA card unless the caller passes
``torch.device("cpu")``, where the kernels' plain versions run.
"""

__version__ = "0.1.0"
