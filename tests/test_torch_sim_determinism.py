"""The reference's same-seed trace tests run against the port: every test
of tests/test_sim_determinism.py, with its own assertions, on both
packages.

Each of those tests runs its own file as a child process (``_THIS``,
``--child <trace> <mode>``): a seeded 5-machine simulated cluster in one
of 14 modes, which prints the SHA-256 of its trace and its event counts;
the test holds two fresh-process runs of a mode bit-identical and checks
the mode's markers in the trace.  The port's half runs the reference's
source re-rooted at the port (``torch_parity.reference_module``) with
``_THIS`` pointed at a child written under the test's directory:
``chip_smoke.sim_child_source``, the same file re-rooted at the port
with its simulated cluster on the CPU (the kernels' plain versions),
and its client refresh gathered (``gathered_child_source``, as
``torch_parity.gathered`` does in process): the port's refresh returns
once a majority of coordinators has answered (ROADMAP C3), and the
cancelled request to the last one draws nothing more from the
simulated network, so every later event of the port as it is moves.
``chip_smoke.py`` phase 31 runs that child, as it is, on the card.

Then every child run of the port is held to the reference's run at the
same place: the same mode, the same printed event counts, and the two
traces equal event by event, apart from two fields, each a gauge whose
value differs between the packages by design or by a repair:

- ``ResolverMetrics.WindowOccupancy``, the share of the conflict set's
  host-visible ring in use.  The reference's default backend is the
  numpy twin, which keeps one; the port's is the ``cuda`` backend, whose
  ring lives in tensors, so it reports 0.0, as the reference's ``tpu``
  backend does (ROADMAP C, divergences by design).
- ``StorageMetrics.DeviceReadStaleness``, how many versions a storage
  server's read mirror trails its tip (durable modes only).  The
  reference never arms the mirror of a storage server recruited onto a
  disk, so it reports 0; the port arms it (a repair, ROADMAP C, held
  by ``test_recruited_storage_arms_the_read_mirror`` in
  tests/test_torch_recovery.py).

A failure names the first event that differs beyond them.  So the
gathered port's digest differs from the reference's in every mode that
emits either gauge with a nonzero value, and equals it in the others
(``metrics_off``).  The port as it is, in phase 31's own child
(``python chip_smoke.py --sim-mode MODE TRACE cpu``), must hash each
of phase 31's modes to ``chip_smoke.SIM_DIGESTS``, the digests the
card's runs are held to.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
sys.path.insert(0, TESTS)

from torch_parity import (PORT, REF, buggify_off,  # noqa: E402,F401
                          one_torch_thread, reference_cases,
                          run_reference_test)

sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

CASES = {
    "test_sim_determinism.py": [
        "test_same_seed_sim_trace_bit_identical_with_pipeline",
        "test_same_seed_sim_trace_bit_identical_metrics_emitter_off",
        "test_same_seed_sim_trace_bit_identical_with_spill_forced_on",
        "test_same_seed_sim_trace_bit_identical_with_disk_faults_on",
        "test_same_seed_sim_trace_bit_identical_mvcc_knob_both_ways",
        "test_same_seed_sim_trace_bit_identical_lsm_knob_both_ways",
        "test_same_seed_sim_trace_bit_identical_mesh_knob_both_ways",
        "test_same_seed_sim_trace_bit_identical_devplane_knobs_flipped",
        "test_same_seed_sim_trace_bit_identical_layers_knobs_flipped",
        "test_same_seed_sim_trace_bit_identical_scrub_knob_both_ways",
    ],
}

# the fields left out of the trace comparison, by event type (above)
LEFT_OUT = {"ResolverMetrics": {"WindowOccupancy"},
            "StorageMetrics": {"DeviceReadStaleness"}}


def gathered_child_source() -> str:
    """The port's child (``chip_smoke.sim_child_source``) with its client
    refresh and its election rounds waiting for every coordinator, as the
    reference's do."""
    anchor = "    sys.path.insert(0, _REPO)\n"
    src = cs.sim_child_source(REPO)
    assert src.count(anchor) == 1
    return src.replace(anchor, anchor + (
        "    from foundationdb_tpu_torch.core import coordination\n"
        "    coordination.MAJORITY_ROUNDS = False\n"))


def child_runs(name: str, file: str, test: str, mp, tmp) -> list:
    """Package ``name``'s run of the reference's ``file::test``, its own
    assertions included; returns each child it ran, in order: (tag,
    mode, the printed digest and counts, the trace's bytes)."""
    runs: list = []

    def args(mod):
        real = mod._run_child

        def recording(tmp_path, tag, mode="default"):
            out = real(tmp_path, tag, mode)
            runs.append((tag, mode, out, mod._trace_bytes(tmp_path, tag)))
            return out
        mod._run_child = recording
        if name == PORT:
            child = tmp / "port_child.py"
            child.write_text(gathered_child_source())
            mod._THIS = str(child)
        return {"tmp_path": tmp}
    run_reference_test(file, test, name, mp, args=args)
    return runs


def first_divergence(ref: bytes, port: bytes):
    """(event index, type, fields) of the first event where two traces
    differ beyond ``LEFT_OUT``, or None."""
    a, b = ref.splitlines(), port.splitlines()
    for i, (x, y) in enumerate(zip(a, b)):
        if x == y:
            continue
        ex, ey = json.loads(x), json.loads(y)
        skip = LEFT_OUT.get(ex.get("Type"), set()) \
            if ex.get("Type") == ey.get("Type") else set()
        fields = sorted(k for k in ex.keys() | ey.keys()
                        if ex.get(k) != ey.get(k) and k not in skip)
        if fields:
            return i, ex.get("Type"), fields
    if len(a) != len(b):
        return min(len(a), len(b)), "the end of one trace", []
    return None


@pytest.mark.parametrize("file,test", reference_cases(CASES))
def test_reference_sim_determinism(file, test, monkeypatch,
                                   tmp_path_factory):
    # one CPU thread for each child: the suite's workers share the host
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ref, port = (child_runs(name, file, test, monkeypatch,
                            tmp_path_factory.mktemp(name))
                 for name in (REF, PORT))
    assert [r[:2] for r in ref] == [p[:2] for p in port]
    for (tag, mode, r, rt), (_, _, p, pt) in zip(ref, port):
        assert r[1:] == p[1:], f"{mode} ({tag}): event counts {r} {p}"
        assert first_divergence(rt, pt) is None, \
            f"{mode} ({tag}): first divergent event {first_divergence(rt, pt)}"


@pytest.mark.parametrize("mode", cs.SIM_MODES)
def test_phase_31_child_hashes_to_the_held_digest(mode, tmp_path):
    """Phase 31's child for ``mode`` on the CPU, the port as it is: the
    trace's SHA-256 is ``chip_smoke.SIM_DIGESTS[mode]``, and every
    kernel call it made equals its plain version."""
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--sim-mode",
         mode, str(tmp_path / "trace.jsonl"), "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert p.returncode == 0, p.stderr[-3000:]
    digest_line, calls_line = p.stdout.strip().splitlines()[-2:]
    assert digest_line.split()[0] == cs.SIM_DIGESTS[mode], digest_line
    calls = json.loads(calls_line)["calls"]
    assert not any(err for _, err in calls.values()), calls


def test_phase_31_modes_are_held_by_part_one():
    """Every mode phase 31 runs on the card has a held digest, and is
    a mode of one of the reference's tests held above."""
    src = open(os.path.join(TESTS, "test_sim_determinism.py")).read()
    assert set(cs.SIM_MODES) == set(cs.SIM_DIGESTS)
    for mode in cs.SIM_MODES:
        assert mode == "default" or f'mode="{mode}"' in src, mode


@pytest.mark.cuda
def test_sim_modes_on_the_card(tmp_path):
    """``chip_smoke.py`` phase 31's gates: each mode's card and CPU
    traces hash to its held digest, every K1, K3, K2 and B8 call equals
    its plain version, and the devplane mode launches K2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from foundationdb_tpu_torch.ops import kernels as K
    K.build_missing()
    cs._START[0] = time.perf_counter()      # the phase's waits count from here
    cs.check_sim_modes_phase(cs.sim_modes_phase(str(tmp_path)))
