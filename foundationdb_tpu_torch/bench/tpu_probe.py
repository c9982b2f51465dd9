"""Detached device probe.

A bench that drives the card first has a disposable child — this module —
prove the card usable by writing ``{"state": "ok"}`` to a status file.
The child writes its progress as it goes (``starting``, ``devices``,
then ``ok``, ``cpu-only`` or ``error``), so a parent that stops waiting
still reads how far it got.  On the card it reports the device's name,
its SM count, the host-to-device-to-host round trip of one int32 (the
least of 8) and one 128x128 bf16 matmul.

Run: ``python -m foundationdb_tpu_torch.bench.tpu_probe --out STATUS.json``
"""

from __future__ import annotations

import argparse
import json
import os
import time


def write_status(path: str, d: dict) -> None:
    d = dict(d, ts=time.time(), pid=os.getpid())
    with open(path + ".tmp", "w") as f:
        json.dump(d, f)
    os.replace(path + ".tmp", path)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    write_status(args.out, {"state": "starting"})
    try:
        import torch

        t0 = time.time()
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs = [torch.cuda.get_device_name(i) for i in range(n)] or ["cpu"]
        write_status(args.out, {"state": "devices", "devices": devs,
                                "init_s": time.time() - t0})
        if n == 0:
            write_status(args.out, {"state": "cpu-only", "devices": devs})
            return 0
        dev = torch.device("cuda", 0)
        props = torch.cuda.get_device_properties(dev)
        one = torch.ones(1, dtype=torch.int32)
        rtt = []
        for _ in range(8):
            t = time.perf_counter()
            back = one.to(dev).cpu()
            rtt.append(time.perf_counter() - t)
        t1 = time.time()
        x = torch.ones((128, 128), dtype=torch.bfloat16, device=dev)
        y = torch.matmul(x, x)
        torch.cuda.synchronize(dev)
        write_status(args.out, {"state": "ok",
                                "platform": "gpu",
                                "device": torch.cuda.get_device_name(dev),
                                "devices": devs,
                                "sm_count": props.multi_processor_count,
                                "init_s": t1 - t0,
                                "roundtrip_s": min(rtt),
                                "roundtrip_value": int(back[0]),
                                "matmul_s": time.time() - t1,
                                "result_00": float(y[0, 0])})
        return 0
    except Exception as e:            # noqa: BLE001 — status file is the contract
        write_status(args.out, {"state": "error", "error": repr(e)[:800]})
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
