"""The installable packages carry the PyTorch port, and the installed port
runs from them alone.

The deb is built once (scripts/make_deb.sh into this module's own dir,
on the binaries the native_build fixture built) and extracted with
dpkg-deb -x. Every subprocess runs from a temp working directory with
only the extracted dist-packages on PYTHONPATH, refuses the packages its
case must not need, and checks that dynolog_tpu_torch came from the
extracted tree.
The deb tests skip without dpkg-deb, the rpm test without the rpm tools,
as tests/test_packaging.py does.
"""

import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import pytest

from dynolog_tpu_torch.utils.procutil import wait_for_stderr
from dynolog_tpu_torch.utils.rpc import DynoClient

REPO = pathlib.Path(__file__).resolve().parent.parent
DIST = "usr/lib/python3/dist-packages"
PACKAGES = ("dynolog_tpu", "dynolog_tpu_torch")
FLEET_TOOLS = ("unitrace", "fleetstatus", "trace_report", "eventlog")
JOB = "packaged"

needs_dpkg = pytest.mark.skipif(
    shutil.which("dpkg-deb") is None, reason="dpkg-deb not available")

# Run as `python -c` in the extracted tree: refuse some top-level
# packages, check where the port comes from, then run the body.
_PRELUDE = """\
import importlib.abc, os, sys
REFUSED = {refused!r}
class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(name + " is refused here")
sys.meta_path.insert(0, _Refuse())
import dynolog_tpu_torch
assert dynolog_tpu_torch.__file__.startswith({root!r} + os.sep), \\
    dynolog_tpu_torch.__file__
"""

_RUN_MODULE = """\
import runpy
sys.argv = [{module!r}, *{argv!r}]
runpy.run_module({module!r}, run_name="__main__", alter_sys=True)
"""

# A CPU training loop under the packaged shim, until its stdin closes or
# 60 s pass.
_CLIENT = """\
import threading, time
import torch
from dynolog_tpu_torch.client import enable
torch.set_num_threads(1)
closed = threading.Event()
threading.Thread(target=lambda: (sys.stdin.read(), closed.set()),
                 daemon=True).start()
client = enable(job_id={job!r}, poll_interval_s=0.1)
x = torch.randn(64, 64)
deadline = time.monotonic() + 60
while not closed.is_set() and time.monotonic() < deadline:
    x = torch.tanh(x @ x)
    client.step()
    time.sleep(0.005)
client.stop()
"""


def _wait_for(predicate, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    pytest.fail(f"timed out waiting for {what}")


def _repo_files(pkg):
    base = REPO / pkg
    return {str(p.relative_to(base)): p for p in base.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def deb_root(native_build, tmp_path_factory):
    """(deb, extracted root), built from the binaries of the native_build
    fixture, made before make_deb.sh looks for them."""
    assert (native_build / "dynolog_tpu_daemon").exists()
    out = tmp_path_factory.mktemp("torchdist")
    subprocess.run([str(REPO / "scripts" / "make_deb.sh"), str(out)],
                   check=True, capture_output=True, text=True, timeout=120)
    debs = list(out.glob("*.deb"))
    assert len(debs) == 1
    root = out / "rootfs"
    subprocess.run(["dpkg-deb", "-x", str(debs[0]), str(root)], check=True,
                   timeout=60)
    return debs[0], root


@pytest.fixture
def work_dir():
    """A working directory outside the repo, so that `python -c` (which
    puts it first on sys.path) cannot import the repo's copies."""
    d = tempfile.mkdtemp(prefix="dtpk")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _packaged_python(root, work_dir, body, refused, **popen):
    """`python -c PRELUDE + body` from ``work_dir`` with only the
    extracted dist-packages on PYTHONPATH."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "DYNOLOG_TPU_ENABLED")}
    env["PYTHONPATH"] = str(root / DIST)
    code = _PRELUDE.format(refused=refused, root=str(root)) + body
    return [sys.executable, "-c", code], dict(cwd=work_dir, env=env, **popen)


@needs_dpkg
@pytest.mark.parametrize("pkg", PACKAGES)
def test_deb_carries_package_byte_for_byte(deb_root, pkg):
    _, root = deb_root
    base = root / DIST / pkg
    packaged = {str(p.relative_to(base)) for p in base.rglob("*")
                if p.is_file()}
    want = _repo_files(pkg)
    assert packaged == set(want)
    for rel, src in want.items():
        assert (base / rel).read_bytes() == src.read_bytes(), rel


@needs_dpkg
def test_deb_control_names_both_frameworks_and_not_torch(deb_root):
    deb, _ = deb_root
    info = subprocess.run(["dpkg-deb", "--info", str(deb)],
                          capture_output=True, text=True, check=True,
                          timeout=30).stdout
    assert "JAX and PyTorch processes" in info
    assert "torch comes from the training environment" in info
    depends = next(line for line in info.splitlines()
                   if line.strip().startswith("Depends:"))
    assert "torch" not in depends


@needs_dpkg
def test_packaged_selftest_runs_from_the_extracted_tree(deb_root, work_dir):
    _, root = deb_root
    daemon = root / "usr/local/bin/dynolog_tpu_daemon"
    args, kw = _packaged_python(
        root, work_dir,
        _RUN_MODULE.format(module="dynolog_tpu_torch.client.selftest",
                           argv=["--device", "cpu", "--daemon",
                                 str(daemon)]),
        refused=("jax", "jaxlib", "dynolog_tpu"))
    out = subprocess.run(args, capture_output=True, text=True, timeout=120,
                         **kw)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK: torch.profiler trace written" in out.stdout


@needs_dpkg
def test_packaged_gputrace_reaches_a_packaged_client(deb_root, work_dir,
                                                     fixture_root, tmp_path):
    _, root = deb_root
    sock_dir = tempfile.mkdtemp(prefix="dtps")
    env = {**os.environ, "DYNOLOG_TPU_SOCKET_DIR": sock_dir}
    daemon = subprocess.Popen(
        [str(root / "usr/local/bin/dynolog_tpu_daemon"), "--port", "0",
         "--procfs_root", str(fixture_root),
         "--kernel_monitor_interval_s", "3600",
         "--tpu_monitor_interval_s", "3600"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=env)
    client = None
    try:
        m, buf = wait_for_stderr(daemon, r"rpc: listening on port (\d+)")
        assert m, buf
        port = int(m.group(1))
        client_log = tmp_path / "client.log"
        with open(client_log, "w") as log:
            args, kw = _packaged_python(
                root, work_dir, _CLIENT.format(job=JOB),
                refused=("jax", "jaxlib", "dynolog_tpu"),
                stdin=subprocess.PIPE, stdout=log, stderr=subprocess.STDOUT)
            kw["env"]["DYNOLOG_TPU_SOCKET_DIR"] = sock_dir
            client = subprocess.Popen(args, **kw)
        rpc = DynoClient(port=port)
        _wait_for(lambda: rpc.status()["registered_processes"] == 1
                  or client.poll() is not None, 60, "client registration")
        assert client.poll() is None, client_log.read_text()

        log_dir = tmp_path / "trace"
        out = subprocess.run(
            [str(root / "usr/local/bin/dyno"), "--port", str(port),
             "gputrace", "--job_id", JOB, "--duration_ms", "300",
             "--log_dir", str(log_dir)],
            capture_output=True, text=True, timeout=30)
        assert out.returncode == 0 and "Triggered 1" in out.stdout, (
            out.stdout + out.stderr)

        def landed(name):
            return [p for p in log_dir.rglob(name)
                    if not p.name.startswith("streamed.")]

        _wait_for(lambda: landed("*.pt.trace.json")
                  and landed("dynolog_manifest.json"), 60, "the artifacts")
        trace = json.loads(landed("*.pt.trace.json")[0].read_text())
        assert trace["traceEvents"]
        manifest = json.loads(landed("dynolog_manifest.json")[0].read_text())
        assert manifest["trace_timing"]["trace_stop"] > 0
    finally:
        if client is not None:
            client.stdin.close()
            try:
                client.wait(timeout=30)
            except subprocess.TimeoutExpired:
                client.kill()
                client.wait()
        daemon.send_signal(signal.SIGTERM)
        try:
            daemon.wait(timeout=5)
        except subprocess.TimeoutExpired:
            daemon.kill()
            daemon.wait()
        shutil.rmtree(sock_dir, ignore_errors=True)


@needs_dpkg
@pytest.mark.parametrize("tool", FLEET_TOOLS)
def test_packaged_fleet_tool_runs_without_torch(deb_root, work_dir, tool):
    _, root = deb_root
    args, kw = _packaged_python(
        root, work_dir,
        _RUN_MODULE.format(module=f"dynolog_tpu_torch.fleet.{tool}",
                           argv=["--help"]),
        refused=("torch", "jax", "jaxlib", "dynolog_tpu"))
    out = subprocess.run(args, capture_output=True, text=True, timeout=60,
                         **kw)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("usage:")


rpm_tools = shutil.which("rpmbuild") and shutil.which("rpm")


@pytest.mark.skipif(not rpm_tools, reason="rpm toolchain not available")
def test_rpm_payload_carries_the_port(native_build, tmp_path):
    assert (native_build / "dynolog_tpu_daemon").exists()
    out = tmp_path / "dist"
    subprocess.run([str(REPO / "scripts" / "make_rpm.sh"), str(out)],
                   check=True, capture_output=True, text=True, timeout=300)
    rpms = list(out.glob("*.rpm"))
    assert len(rpms) == 1
    listing = subprocess.run(["rpm", "-qpl", str(rpms[0])],
                             capture_output=True, text=True, check=True,
                             timeout=60).stdout
    assert "dynolog_tpu_torch/client/shim.py" in listing
    assert "dynolog_tpu/client/shim.py" in listing
