"""``correct`` comes out false when the timed path is broken underneath:
the rest of a run is driven as the benchmark drives it (the card's
look skipped: the port's plain path on the CPU), with each fault the
cells can have planted in the program's place.  The exchange between
chips is no fault of these cells: each runs on one chip.  The control,
the program's own narrower key encoding, fails as well."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kvbench import harness, spec

from kvbench_small import card, cells, small_root, whole_passes  # noqa: F401

pytestmark = pytest.mark.usefixtures("whole_passes")


class Wrap:
    """The backend, with its group entry replaced."""

    def __init__(self, backend):
        self._b = backend

    def __getattr__(self, name):
        return getattr(self._b, name)


def _half(w):
    """The first half of a wire batch's txns."""
    from foundationdb_tpu_torch.ops.batch import WireBatch
    n = w.count // 2
    k = 2 * int(w.nr[:n].sum() + w.nw[:n].sum())
    return WireBatch(w.blob[:int(w.offs[k])], w.offs[:k + 1].copy(),
                     w.nr[:n].copy(), w.nw[:n].copy(),
                     w.snapshots[:n].copy(), n)


class HalfBatch(Wrap):
    """Half of each batch left out: its verdicts read committed."""

    def resolve_group_wire_begin(self, wires, versions):
        aw = self._b.resolve_group_wire_begin([_half(w) for w in wires],
                                              versions)

        async def done():
            got = await aw
            return [v + [0] * (w.count - len(v)) for v, w in zip(got, wires)]
        return done()


class Altered(Wrap):
    """One verdict of each group altered where it is produced."""

    def resolve_group_wire_begin(self, wires, versions):
        aw = self._b.resolve_group_wire_begin(wires, versions)

        async def done():
            got = await aw
            got[0][0] = 1 if got[0][0] == 0 else 0
            return got
        return done()


class Dropped(Wrap):
    """The last batch of each group never comes back."""

    def resolve_group_wire_begin(self, wires, versions):
        aw = self._b.resolve_group_wire_begin(wires, versions)

        async def done():
            return (await aw)[:-1]
        return done()


def unchanged_state(backend):
    """Each group's dispatch returns the conflict history unchanged."""
    cs = backend.cs
    inner = cs.resolve_group_submit_fused

    def frozen(*args, **kwargs):
        before = cs.state
        out = inner(*args, **kwargs)
        if before is not None:
            cs.state = before
        return out
    cs.resolve_group_submit_fused = frozen
    return backend


FAULTS = {"unchanged_state": unchanged_state, "half_batch": HalfBatch,
          "altered_answer": Altered, "dropped_batch": Dropped}


def _run(root, cell, hook=None, knobs=None):
    bench = spec.load(root)
    return harness.run(bench, spec.cell(bench, cell), 5, 0.5, False,
                       torch.device("cpu"), 0.0, root=root,
                       backend_hook=hook, knobs=knobs)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", cells())
def test_a_fault_is_not_correct(small_root, cell, fault):
    run = _run(small_root, cell, hook=FAULTS[fault])
    assert run.result["correct"] is False
    assert sum(run.checks[k] for k in harness.LIMITS) > 0


# the control: the configuration's 32-byte keys read through a narrower
# encoding (mako's 32-byte keys share their first 24 bytes; New-Order's
# keys are at most 19 bytes, so only 8 bytes breaks them)
CONTROL = {"mako5050-z099.grouped": 24, "tpcc-neworder-w100.grouped": 8}


@pytest.mark.parametrize("cell", cells())
def test_the_control_is_not_correct(small_root, cell):
    run = _run(small_root, cell, knobs={"KEY_ENCODE_BYTES": CONTROL[cell]})
    assert run.result["correct"] is False
    assert run.checks["false_conflicts"] > 0


def test_new_order_keys_stay_exact_at_16_bytes(small_root):
    run = _run(small_root, "tpcc-neworder-w100.grouped",
               knobs={"KEY_ENCODE_BYTES": 16})
    assert run.result["correct"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_the_control_on_the_card(small_root, cell, card):
    bench = spec.load(small_root)
    for width, want in ((32, True), (CONTROL[cell], False)):
        run = harness.run(bench, spec.cell(bench, cell), 9, 1.0, False,
                          card, 0.0, root=small_root,
                          knobs={"KEY_ENCODE_BYTES": width})
        assert run.result["correct"] is want
        assert np.isfinite(run.window_s)
