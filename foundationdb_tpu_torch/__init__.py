"""foundationdb_tpu_torch — the PyTorch/CUDA port of foundationdb_tpu.

The JAX package beside it stays the reference; this package is fed the
same inputs and must give bit-identical verdicts and ring state.  It
imports ``torch`` and numpy and nothing of ``jax`` or
``foundationdb_tpu``: the jax-free modules it needs are its own copies.

The resolver's conflict-detection path, the in-process commit path
around it, the multi-process cluster, the consumers of the commit
stream, simulation testing, and the operator's and the application's
entry points:
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
             scrubber, status); the remote region's log router
  storage/   the MVCC window and the storage engines (copies)
  rpc/       the wire codec, the simulated and TCP transports, the role
             stubs, the failure monitor (copies)
  client/    Database / Transaction with read-your-writes, special keys,
             the tuple, subspace and directory layers, the API-version
             gate (copies)
  backup/    feed-native backup and point-in-time restore, the task
             bucket, the raw tag stream, cluster-to-cluster DR (copies)
  layers/    read-through cache, watches, the shared feed consumer,
             secondary indexes, the layer consistency checker (copies)
  sim/       the simulated cluster: machines, kills, reboots, regions;
             one seeded chaos run (run_one) and the spec files
  server.py  one cluster process: ``python -m foundationdb_tpu_torch.server
             -C fdb.cluster -l IP:PORT [--device cuda|cpu]``
  cli.py     fdbcli: ``python -m foundationdb_tpu_torch.cli -C fdb.cluster
             --exec "set k v; get k; status"`` (a client: no device)
  monitor.py fdbmonitor: starts, restarts and stops the conf's servers,
             each with the conf's ``device`` (default ``cuda``)
  capi_host.py, bindings/
             the C ABI (bindings/c, libfdbtpu_c.so in _build/), the
             Python binding over it and the bindingtester's stack machine
  tools/     the seed farm (``--device cuda|cpu``), the trace and metrics
             tools, the resolve stage of the perf smoke
  native/    the C++ conflict set, the key codec and the C ABI's shim,
             built with g++ into _build/
  bench/     the mako workload generator, the end-to-end mako loop,
             the resolver profiles

Entry points run on the CUDA card unless the caller passes
``torch.device("cpu")``, where the kernels' plain versions run.
"""

__version__ = "0.1.0"
