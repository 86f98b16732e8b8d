"""The port bench's quantile-sketch phase against bench.py's own, and
the multi-tenant phase's abuser program, on the CPU.

  * ``measure_sketch_quantiles`` at bench.py's full sizes (pure Python,
    seeded): every key but the three timings equals bench.py's (exact);
  * the abusive tenant's ``python -c`` program, run from outside the
    repo against a daemon with a token file, is served as tenant
    ``abuser`` and imports the port's RPC client and nothing of JAX or
    of the JAX package (``python -X importtime`` lists every import).
"""

import ast
import os
import re
import subprocess
import sys
import time

import bench as ref_bench
from dynolog_tpu_torch import bench
from dynolog_tpu_torch.fleet import minifleet
from dynolog_tpu_torch.utils.rpc import DynoClient
from torch_bench_util import bounded, held, short_tmp, sock_dir  # noqa: F401

_TIMINGS = {"add_us_per_sample", "tree_merges_per_s", "tree_merge_passes"}


def test_sketch_quantiles_equal_the_reference_at_full_size():
    assert (bench.FULL.sketch_samples, bench.FULL.sketch_big_samples) == (
        200_000, 1_000_000)
    ref = bounded(ref_bench.measure_sketch_quantiles)
    port = bounded(bench.measure_sketch_quantiles)
    held("sketch_quantiles", ref, port)
    assert {k: v for k, v in port.items() if k not in _TIMINGS} == \
        {k: v for k, v in ref.items() if k not in _TIMINGS}
    assert port["worst_relative_error"] <= port["documented_error_bound"]
    assert port["wire_bytes_ratio"] < 0.05


_BANNED = ("jax", "jaxlib", "optax", "dynolog_tpu")


def test_abuser_script_imports_only_the_port(daemon_bin, sock_dir,
                                             short_tmp):
    script = bench.abuser_script(port=1, rate=200)
    imported = {a.name for node in ast.walk(ast.parse(script))
                if isinstance(node, ast.Import) for a in node.names}
    imported |= {node.module for node in ast.walk(ast.parse(script))
                 if isinstance(node, ast.ImportFrom)}
    assert imported == {"os", "sys", "time", "dynolog_tpu_torch.utils.rpc"}

    tokens = minifleet.write_token_file(
        os.path.join(short_tmp(), "tokens"),
        [("benchfleet", "fleet", "admin"), ("bench-abuser", "abuser")])
    proc, port = bench._drained(bench.start_daemon(
        daemon_bin, "--fleet_token_file", tokens, "--tenant_rate", "20",
        "--tenant_burst", "20", "--ipc_socket_name", "dtbabuse"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    abuser = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-c",
         bench.abuser_script(port, 200)],
        cwd=short_tmp(), env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        client = DynoClient(port=port)
        deadline = time.monotonic() + 30
        counts = {}
        while time.monotonic() < deadline and abuser.poll() is None:
            counts = client.status()["rpc"].get("tenants", {}).get(
                "abuser", {})
            if counts.get("served", 0) + counts.get("shed", 0) >= 20:
                break
            time.sleep(0.1)
        assert abuser.poll() is None, abuser.stderr.read()[-4000:]
        assert counts.get("served", 0) > 0
    finally:
        abuser.kill()
        _, err = abuser.communicate(timeout=10)
        bench.stop_daemon(proc)
    modules = {m.group(1) for m in re.finditer(
        r"^import time:\s+\d+ \|\s+\d+ \|\s*(\S+)", err, re.MULTILINE)}
    assert "dynolog_tpu_torch.utils.rpc" in modules
    assert not [m for m in modules if m.split(".")[0] in _BANNED]
