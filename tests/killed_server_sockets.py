"""How long a SIGKILLed server's sockets outlive it.

Phase 25's deployment (``chip_smoke.Deployment``: fdbmonitor, three
coordinator servers and a worker-only fourth, each ``--device
DEVICE``), a first commit through the CLI, then for the first
coordinator server: its open sockets and ``/dev/nvidia*`` files listed,
a raw TCP connection opened to its port, the monitor SIGSTOPped and
the server SIGKILLed; then every 0.1 s for up to 150 s, until 20 s
after the connection closes (EOF or reset), what
``chip_smoke.KillWatch`` reads from ``/proc`` (the process's state,
open files and sockets; its
port's LISTEN entry; the states of the sockets to and at its port; this
process's own sockets to the four servers) beside whether that
connection has closed, its state in ``/proc/net/tcp`` (matched by its
inode) and what a new connection gets within 0.2 s (accepted, refused,
or ``TimeoutError``: a dial that hangs).

    python tests/killed_server_sockets.py [DEVICE]

``DEVICE`` is ``cuda`` (the default) or ``cpu``.  Prints one JSON line:
the fds, the seconds until the connection closed, and each change.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def fds(pid: int) -> dict:
    out = {}
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            out[int(fd)] = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            pass
    return out


def new_connection(port: int) -> str:
    s = socket.socket()
    s.settimeout(0.2)
    try:
        s.connect(("127.0.0.1", port))
        return "accepted"
    except ConnectionRefusedError:
        return "refused"
    except OSError as e:
        return type(e).__name__
    finally:
        s.close()


def closed(conn: socket.socket) -> bool:
    try:
        return conn.recv(1) == b""
    except BlockingIOError:
        return False
    except OSError:
        return True


def main(argv=None) -> int:
    import chip_smoke as cs

    argv = sys.argv[1:] if argv is None else argv
    dev = argv[0] if argv else "cuda"
    card = "cpu" if dev == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    cs._START[0] = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = cs.Deployment(dev, os.path.join(tmp, "k"), [])
        try:
            d.until("set first 1", "Committed", 300)
            time.sleep(2)
            port = d.ports[0]
            pid = d.started()[port][-1]
            table = fds(pid)
            conn = socket.create_connection(("127.0.0.1", port), 5)
            conn.setblocking(False)
            inode = os.fstat(conn.fileno()).st_ino

            def own():
                return [closed(conn), next(
                    (st for _, _, st, ino in cs.tcp_sockets()
                     if ino == inode), "none"), new_connection(port)]
            os.kill(d.mon.pid, signal.SIGSTOP)
            os.kill(pid, signal.SIGKILL)
            watch = cs.KillWatch(pid, port, d.ports, extra=own)
            t0 = time.perf_counter()
            closed_at = None
            while time.perf_counter() - t0 < 150:
                if closed_at is None and watch.rows \
                        and watch.rows[-1]["extra"][0]:
                    closed_at = watch.rows[-1]["t"]
                if closed_at is not None \
                        and time.perf_counter() - t0 > closed_at + 20:
                    break
                time.sleep(0.05)
            changes = watch.stop()
            conn.close()
            print(json.dumps({
                "port": port, "pid": pid, "card": card,
                "socket_fds": sorted(fd for fd, t in table.items()
                                     if t.startswith("socket:")),
                "nvidia_fds": sorted(fd for fd, t in table.items()
                                     if "nvidia" in t),
                "connection_closed_s": closed_at,
                "summary": cs.watch_summary(changes),
                "changes": changes}), flush=True)
        finally:
            d.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
