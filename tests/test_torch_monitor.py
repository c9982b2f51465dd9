"""The port's fdbmonitor (``foundationdb_tpu_torch.monitor``) against the
JAX package's.

tests/test_monitor.py's scenario runs as written against the port
(``torch_parity.reference_module``), its conf giving every server
``device = cpu``: the monitor starts three coordinator servers and one
worker-only server (``python -m foundationdb_tpu_torch.server``), the
port's CLI commits through them, the worker-only server is SIGKILLed,
the monitor restarts it, and the cluster serves through the CLI again.

A server whose ``device`` is ``cuda`` (the default) on a machine without
a card exits at start-up with the reason in its log, and the monitor
starts it again with ``--device cuda``: it never moves a server to the
CPU.  A ``cuda``-marked twin runs ``chip_smoke.py``'s phase 25 (the
operator's deployment on the card) with its gates.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (ONE_THREAD, PORT,  # noqa: E402,F401
                          api_version_reset, buggify_off, one_torch_thread,
                          reference_module)
from test_server import free_ports  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the scenario's conf: every server on the CPU
ON_CPU = ('"restart-delay = 0.5\\n"',
          '"restart-delay = 0.5\\n" "device = cpu\\n"')


def test_monitor_restarts_crashed_server(tmp_path):
    reference_module("test_monitor.py", PORT, edits=[
        ON_CPU, ONE_THREAD]).test_monitor_restarts_crashed_server(tmp_path)


def test_monitor_never_moves_a_cuda_server_to_the_cpu(tmp_path):
    """``device`` defaults to ``cuda``; with no card visible the server
    exits at start-up naming the missing device, and every restart runs
    it with ``--device cuda`` again."""
    port = free_ports(1)[0]
    cf = tmp_path / "fdb.cluster"
    cf.write_text(f"nocard:t1@127.0.0.1:{port}\n")
    conf = tmp_path / "fdbmonitor.conf"
    conf.write_text(f"[general]\ncluster-file = {cf}\nrestart-delay = 0.2\n"
                    f"[fdbserver.{port}]\nlisten = 127.0.0.1:{port}\n")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    err = tmp_path / "monitor.err"
    with open(err, "wb") as f:
        mon = subprocess.Popen(
            [sys.executable, "-m", "foundationdb_tpu_torch.monitor", "-C",
             str(conf)], cwd=REPO, env=env, stdout=subprocess.DEVNULL,
            stderr=f)
    log = tmp_path / f"fdbserver.{port}.log"
    try:
        deadline = time.time() + 120
        while err.read_text().count("exited rc=") < 2:
            assert mon.poll() is None and time.time() < deadline, \
                err.read_text()
            time.sleep(0.2)
    finally:
        mon.send_signal(signal.SIGTERM)
        try:
            mon.wait(timeout=30)
        except subprocess.TimeoutExpired:
            mon.kill()
            mon.wait()
    text = err.read_text()
    assert mon.returncode == 0, text
    started = [ln for ln in text.splitlines() if "started fdbserver" in ln]
    assert len(started) >= 2 and all("device=cuda" in ln for ln in started)
    assert "device=cpu" not in text
    assert log.read_text().count("no CUDA device") >= 2


@pytest.mark.cuda
def test_operator_deployment_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    cs.check_deployment_phase(cs.deployment_phase("cuda"), "")
