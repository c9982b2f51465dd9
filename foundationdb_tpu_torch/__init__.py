"""foundationdb_tpu_torch — the PyTorch/CUDA port of foundationdb_tpu.

The JAX package beside it stays the reference; this package is fed the
same inputs and must give bit-identical verdicts and ring state.  It
imports ``torch`` and numpy and nothing of ``jax`` or
``foundationdb_tpu``: the jax-free modules it needs are its own copies.

Ported so far, the resolver's conflict-detection path:
  runtime/   event loop, sim, knobs, trace, errors, RNG (copies)
  ops/       key encoding, batch format, the conflict core on torch
             (conflict_torch), its hand kernels (kernels + csrc/*.cu),
             the backend registry, the C++ exact baseline
  device/    the resolver's device commit pipeline
  core/      the resolver role and the shared data types
  native/    the C++ conflict set, built with g++ into _build/
  bench/     the mako workload generator

Entry points run on the CUDA card unless the caller passes
``torch.device("cpu")``, where the kernels' plain versions run.
"""

__version__ = "0.1.0"
