"""The port's C ABI, its Python binding over it and its bindingtester
against the JAX package's.

tests/test_bindings.py runs as written against the port
(``torch_parity.reference_module``), over three
``foundationdb_tpu_torch.server --device cpu`` processes: the
reference's plain-C smoke program (``bindings/c/test_c_smoke.c``,
unchanged) compiled against the port's header and linked against the
port's ``libfdbtpu_c.so`` (``foundationdb_tpu_torch/native/build.py``),
whose embedded interpreter hosts ``foundationdb_tpu_torch.capi_host``;
then the port's Python binding over that library
(``foundationdb_tpu_torch/bindings/python/fdbtpu.py``) runs the
reference's operation sequence, and the port's CLI reads its writes
back.  The two libraries export the same ``fdbtpu_*`` symbols.

The stack-machine bindingtester of tests/test_tuple_bindingtester.py
(the seeded instruction streams, plain and directory ops) runs on both
packages, each package's native client against its own brute-force
model, and what each showed is held equal: every read, read version
and commit version, and every final stack.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (ONE_THREAD, PORT, REF,  # noqa: E402,F401
                          SERVER_ON_CPU, api_version_reset, buggify_off,
                          hold_to_reference, one_torch_thread, plain,
                          reference_module)

PORT_BINDINGS = reference_module("test_bindings.py", PORT, edits=[
    SERVER_ON_CPU, ONE_THREAD,
    # the port's header, the port's Python binding
    ('"-I", os.path.join(REPO, "bindings/c")',
     '"-I", os.path.join(REPO, "foundationdb_tpu_torch/bindings/c")'),
    ('os.path.join(REPO, "bindings/python")',
     'os.path.join(REPO, "foundationdb_tpu_torch/bindings/python")')])

# three port servers on the CPU for this module's tests
live_cluster = PORT_BINDINGS.live_cluster


def test_c_smoke_program_against_the_port_library(live_cluster, tmp_path):
    PORT_BINDINGS.test_c_abi_smoke_program(live_cluster, tmp_path)


def test_python_binding_over_the_port_c_abi(live_cluster):
    PORT_BINDINGS.test_python_binding_over_c_abi(live_cluster)


def exported(lib: str) -> list[str]:
    out = subprocess.run(["nm", "-D", "--defined-only", lib], check=True,
                         capture_output=True, text=True).stdout
    return sorted(ln.split()[-1] for ln in out.splitlines()
                  if ln.split()[-1].startswith("fdbtpu_"))


def test_port_library_exports_the_reference_abi():
    libs = [importlib.import_module(f"{p}.native.build").build("fdbtpu_c")
            for p in (REF, PORT)]
    assert "_build" in libs[1]
    ref, port = (exported(lib) for lib in libs)
    assert len(ref) == 16 and port == ref


STACK_TESTER = ("from bindings.bindingtester.stack_tester import",
                f"from {PORT}.bindings.bindingtester.stack_tester import")


@pytest.mark.parametrize("test", [
    "test_stack_machine_native_vs_model",
    "test_stack_machine_directory_ops_native_vs_model"],
    ids=["plain", "directory"])
def test_stack_machine_matches_reference(test, monkeypatch):
    stacks = {REF: [], PORT: []}
    for name, mod in ((REF, "bindings"), (PORT, f"{PORT}.bindings")):
        cls = importlib.import_module(
            f"{mod}.bindingtester.stack_tester").StackMachine

        async def run(self, program, _run=cls.run, _out=stacks[name]):
            r = await _run(self, program)
            _out.append(plain(self.stack))
            return r
        monkeypatch.setattr(cls, "run", run)
    shown = hold_to_reference("test_tuple_bindingtester.py", test,
                              monkeypatch, port_edits=[STACK_TESTER])
    # the stacks of the port's last run, the one held to the reference
    # (hold_to_reference runs the port again, its refresh gathered, when
    # the port as it is showed another schedule)
    assert len(stacks[REF]) == 4 and len(stacks[PORT]) in (4, 8)
    assert stacks[PORT][-4:] == stacks[REF]
    assert any(e[0] == "Transaction.get_range" for e in shown["transcript"])
