"""fdbmonitor analog — supervise server processes from a conf file.

Reference: REF:fdbmonitor/fdbmonitor.cpp + the foundationdb.conf format —
one lightweight supervisor per machine starts every configured fdbserver
process, restarts crashed ones with backoff, and tears the family down on
SIGTERM.

Conf format (ini, a subset of foundationdb.conf):

    [general]
    cluster-file = /etc/fdb.cluster
    restart-delay = 2
    device = cuda

    [fdbserver.4500]
    listen = 127.0.0.1:4500
    spec = min_workers=3

``device`` (``cuda`` or ``cpu``; a server's own section overrides
``[general]``; default ``cuda``) is each server's ``--device``: where its
resolvers and storage read mirrors run.  A ``cuda`` server on a machine
without a card exits at start-up with the reason in its log, and the
monitor restarts it with the same arguments: it never moves a server to
the CPU.

Run: ``python -m foundationdb_tpu_torch.monitor -C fdbmonitor.conf``
"""

from __future__ import annotations

import argparse
import configparser
import os
import signal
import subprocess
import sys
import time


class Monitor:
    def __init__(self, conf_path: str) -> None:
        cp = configparser.ConfigParser()
        if not cp.read(conf_path):
            raise SystemExit(f"cannot read conf file {conf_path}")
        g = cp["general"] if "general" in cp else {}
        self.cluster_file = g.get("cluster-file", "fdb.cluster")
        self.restart_delay = float(g.get("restart-delay", 2.0))
        device = g.get("device", "cuda")
        # children write to per-server log files (the reference
        # fdbmonitor's logdir), NEVER to the monitor's own stdout: an
        # inherited pipe nobody drains blocks the servers at 64KB and
        # wedges the whole cluster mid-recovery
        self.logdir = g.get("logdir", "") or os.path.dirname(
            os.path.abspath(conf_path))
        self.servers: list[dict] = []
        for section in cp.sections():
            if not section.startswith("fdbserver."):
                continue
            s = cp[section]
            srv = {
                "id": section.split(".", 1)[1],
                "listen": s["listen"],
                "spec": s.get("spec", ""),
                "device": s.get("device", device),
            }
            if srv["device"] not in ("cuda", "cpu"):
                raise SystemExit(f"{section}: device must be cuda or cpu, "
                                 f"not {srv['device']!r}")
            self.servers.append(srv)
        if not self.servers:
            raise SystemExit("conf names no [fdbserver.*] sections")
        self.procs: dict[str, subprocess.Popen] = {}
        self.restarts: dict[str, int] = {}
        self._stopping = False

    def _spawn(self, srv: dict) -> None:
        cmd = [sys.executable, "-m", "foundationdb_tpu_torch.server",
               "-C", self.cluster_file, "-l", srv["listen"],
               "--device", srv["device"]]
        if srv["spec"]:
            cmd += ["--spec", srv["spec"]]
        log_path = os.path.join(self.logdir, f"fdbserver.{srv['id']}.log")
        log = open(log_path, "ab")
        try:
            self.procs[srv["id"]] = subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()      # the child holds its own fd now
        print(f"[fdbmonitor] started fdbserver.{srv['id']} "
              f"pid={self.procs[srv['id']].pid} device={srv['device']} "
              f"log={log_path}",
              file=sys.stderr, flush=True)

    def run(self) -> int:
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, self._on_signal)
        for srv in self.servers:
            self._spawn(srv)
        while not self._stopping:
            time.sleep(0.5)
            for srv in self.servers:
                p = self.procs.get(srv["id"])
                if p is not None and p.poll() is not None and not self._stopping:
                    self.restarts[srv["id"]] = \
                        self.restarts.get(srv["id"], 0) + 1
                    print(f"[fdbmonitor] fdbserver.{srv['id']} exited "
                          f"rc={p.returncode}; restarting in "
                          f"{self.restart_delay}s", file=sys.stderr, flush=True)
                    time.sleep(self.restart_delay)
                    if not self._stopping:
                        self._spawn(srv)
        for p in self.procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.time() + 10
        for sid, p in self.procs.items():
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            print(f"[fdbmonitor] fdbserver.{sid} stopped rc={p.returncode}",
                  file=sys.stderr, flush=True)
        return 0

    def _on_signal(self, _sig, _frame) -> None:
        self._stopping = True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="foundationdb_tpu_torch.monitor")
    ap.add_argument("-C", "--conffile", default="fdbmonitor.conf")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    return Monitor(args.conffile).run()


if __name__ == "__main__":
    raise SystemExit(main())
