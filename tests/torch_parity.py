"""A fixture the port's parity tests share.

Each package keeps BUGGIFY's switch in a module-level flag
(``runtime/buggify.py``), so a test that turns it on and leaves it on
changes every later simulation in the same worker process.  A parity
test runs the reference and the port under one seed and holds their
results equal, so both must run under the same fault injection: none.
"""

import importlib

import pytest


@pytest.fixture(autouse=True)
def buggify_off():
    """Both packages' BUGGIFY off for the test, as they were after it."""
    # the modules by name: each package's runtime exports a function
    # named buggify too
    ref, port = (importlib.import_module(f"{p}.runtime.buggify") for p in
                 ("foundationdb_tpu", "foundationdb_tpu_torch"))
    was = [m.buggify_enabled() for m in (ref, port)]
    for m in (ref, port):
        m.enable_buggify(False)
    yield
    for m, on in zip((ref, port), was):
        m.enable_buggify(on)
