"""One-command end-to-end smoke test of the trace path on this host.

    python -m dynolog_tpu_torch.client.selftest [--device cpu] [--daemon PATH]

Spawns the daemon (native/build or native/build-manual; build it with
scripts/build.sh first), registers a client, triggers a 300 ms
torch.profiler capture through the RPC control plane while a matmul loop
steps the client, and verifies the Chrome trace on disk. Runs on CUDA
unless asked for the CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pathlib
import signal
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[2]


def _find_daemon() -> pathlib.Path | None:
    for sub in ("build", "build-manual"):
        path = REPO / "native" / sub / "dynolog_tpu_daemon"
        if path.exists():
            return path
    return None


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--daemon", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)

    import torch

    from dynolog_tpu_torch.client import DynologClient
    from dynolog_tpu_torch.models.transformer import resolve_device
    from dynolog_tpu_torch.utils.procutil import wait_for_stderr
    from dynolog_tpu_torch.utils.rpc import DynoClient

    device = resolve_device(args.device)
    daemon_bin = args.daemon or _find_daemon()
    if daemon_bin is None or not daemon_bin.exists():
        print("daemon binary missing; run scripts/build.sh first",
              file=sys.stderr)
        return 2

    tmp = tempfile.mkdtemp(prefix="dynolog_selftest_")
    os.environ["DYNOLOG_TPU_SOCKET_DIR"] = tmp
    proc = subprocess.Popen(
        [str(daemon_bin), "--port", "0",
         "--kernel_monitor_interval_s", "3600",
         "--tpu_monitor_interval_s", "3600"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    client = None
    try:
        m, buf = wait_for_stderr(proc, r"rpc: listening on port (\d+)")
        if not m:
            print(f"daemon did not start: {buf}", file=sys.stderr)
            return 1
        port = int(m.group(1))
        print(f"daemon up on port {port}")

        x = torch.ones((256, 256), device=device)
        client = DynologClient(job_id="selftest", poll_interval_s=0.1)
        client.start()
        rpc = DynoClient(port=port)
        for _ in range(100):
            if rpc.status()["registered_processes"] == 1:
                break
            time.sleep(0.1)
        else:
            print("client never registered", file=sys.stderr)
            return 1
        print("client registered")

        log_dir = os.path.join(tmp, "traces")
        resp = rpc.set_trace_config(
            job_id="selftest",
            config=json.dumps({
                "type": "xplane", "log_dir": log_dir, "duration_ms": 300}))
        if len(resp["activityProfilersTriggered"]) != 1:
            print(f"trace not triggered: {resp}", file=sys.stderr)
            return 1
        print("trace triggered")

        end = time.monotonic() + 20.0
        while client.captures_completed < 1 and time.monotonic() < end:
            x = (x @ x) / 256.0
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            client.step()
            time.sleep(0.005)
        if client.captures_completed != 1:
            print("capture never completed", file=sys.stderr)
            return 1
        traces = glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json"),
                           recursive=True)
        if not traces:
            print("no torch.profiler trace output", file=sys.stderr)
            return 1
        print(f"OK: torch.profiler trace written: {traces[0]}")
        return 0
    finally:
        if client is not None:
            client.stop()
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            proc.kill()


if __name__ == "__main__":
    sys.exit(main())
