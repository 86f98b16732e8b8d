"""The port speaks the reference's wire formats byte for byte, and
imports nothing of JAX or of the JAX package.

The daemon and `dyno` serve both packages, so a datagram or RPC frame
the port emits must be the one the reference would emit for the same
message.
"""

import ast
import json
import os
import pathlib
import shutil
import socket
import subprocess
import sys
import tempfile
import threading

import pytest

from dynolog_tpu.client.fabric import FabricClient as RefFabric
from dynolog_tpu.utils import rpc as ref_rpc
from dynolog_tpu_torch.client.fabric import FabricClient as PortFabric
from dynolog_tpu_torch.utils import rpc as port_rpc

REPO = pathlib.Path(__file__).resolve().parent.parent

_BODIES = {
    "ctxt": {"job_id": "42", "pid": 1234, "metadata": {
        "host": "h", "argv": "python train.py", "push_proto": 1,
        "device_count": 1, "platform": "gpu"}},
    "tmet": {"job_id": "42", "pid": 1234, "devices": [{
        "device": 3, "global_device_id": 0, "platform": "gpu",
        "device_kind": "NVIDIA H100 80GB HBM3", "hbm_used_bytes": 600,
        "hbm_total_bytes": 1000, "hbm_util_pct": 60.0,
        "tensorcore_duty_cycle_pct": 97.0, "tpu_steps_total": 7.0,
        "dyno_self_poll_total": 3}]},
    "phas": {"job_id": "42", "pid": 1234, "op": "push", "phase": "step",
             "t": 1760000000.125},
    "tdir": {"job_id": "42", "pid": 1234, "hostname": "h",
             "captures_completed": 1,
             "trace_timing": {"config_received": 1.5, "trace_stop": 2.5},
             "spans": [], "phase_spans": [], "op_stats": []},
    "pack": {"job_id": "42", "pid": 1234, "token": "abc123"},
}


@pytest.mark.parametrize("msg_type", sorted(_BODIES))
def test_fabric_encode_is_byte_identical(msg_type):
    body = _BODIES[msg_type]
    wire = RefFabric._encode(msg_type, body)
    assert PortFabric._encode(msg_type, body) == wire
    assert PortFabric._decode(wire) == RefFabric._decode(wire)


@pytest.fixture
def sock_dir(monkeypatch):
    """A short socket dir (AF_UNIX paths stay under 108 bytes, which
    pytest's per-test dirs under xdist come close to)."""
    path = tempfile.mkdtemp(prefix="dtw")
    monkeypatch.setenv("DYNOLOG_TPU_SOCKET_DIR", path)
    yield pathlib.Path(path)
    shutil.rmtree(path, ignore_errors=True)


def test_chunked_upload_wire_is_byte_identical(monkeypatch, sock_dir):
    """The tbeg/tchk/tend sequence of a streamed trace upload."""
    monkeypatch.setattr(os, "urandom", lambda n: b"\x07" * n)
    data = bytes(range(256)) * 300  # 76800 bytes -> 3 chunks
    sent = {}
    for name, cls in (("ref", RefFabric), ("port", PortFabric)):
        fab = cls("no_daemon_here")
        log = sent[name] = []

        def record(payload, ancillary, log=log):
            log.append(payload)
            return True

        fab._sendmsg = record
        try:
            assert fab.upload_stream("42", 1234, 0, "streamed.pt.trace.json",
                                     data, timeout_s=0.05,
                                     resume_retries=0) is None
        finally:
            fab.close()
    assert [p[:4] for p in sent["port"]] == [
        b"tbeg", b"tchk", b"tchk", b"tchk", b"tend"]
    assert sent["port"] == sent["ref"]


def test_send_to_a_full_daemon_queue_gives_up_instead_of_blocking(
        monkeypatch, sock_dir):
    """A send never parks in the kernel on a full datagram queue (some
    kernels never wake such a sender): it retries until its deadline,
    then fails soft. A slow reader still gets every datagram."""
    from dynolog_tpu_torch.client import fabric
    monkeypatch.setattr(fabric, "_SEND_TIMEOUT_S", 0.2)
    daemon = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
    daemon.bind(str(sock_dir / "fake_daemon"))
    client = PortFabric("fake_daemon")
    body = {"data": "x" * 40000}
    try:
        sent = 0
        while client.send("tchk", body):  # nobody reads: queue fills
            sent += 1
            assert sent < 10000
        assert client.stats()["fabric_send_failures"] == 1

        got = []

        def reader():
            while len(got) < sent + 50:
                got.append(daemon.recv(65536))

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        assert all(client.send("tchk", body) for _ in range(50))
        t.join(timeout=10)
        assert not t.is_alive() and len(got) == sent + 50
    finally:
        client.close()
        daemon.close()


def _frame_server():
    """One-shot TCP server: records the raw request bytes, answers with
    a fixed JSON reply in the daemon's framing."""
    srv = socket.create_server(("127.0.0.1", 0))
    got = {}

    def serve():
        conn, _ = srv.accept()
        with conn:
            buf = b""
            while len(buf) < 4 or len(buf) < 4 + int.from_bytes(
                    buf[:4], sys.byteorder):
                chunk = conn.recv(65536)
                if not chunk:
                    break
                buf += chunk
            got["raw"] = buf
            reply = json.dumps({"activityProfilersTriggered": [1]}).encode()
            conn.sendall(len(reply).to_bytes(4, sys.byteorder) + reply)
        srv.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return srv.getsockname()[1], got, t


def test_rpc_framing_is_byte_identical():
    cfg = {"type": "xplane", "log_dir": "/tmp/t", "duration_ms": 500}
    raw = {}
    for name, mod in (("ref", ref_rpc), ("port", port_rpc)):
        port, got, t = _frame_server()
        resp = mod.DynoClient(port=port, timeout=5).set_trace_config(
            job_id="42", config=cfg)
        t.join(timeout=5)
        assert not t.is_alive()
        assert resp == {"activityProfilersTriggered": [1]}
        raw[name] = got["raw"]
    assert raw["port"] == raw["ref"]
    a, b = socket.socketpair()
    with a, b:
        port_rpc._send_frame(a, b'{"fn": "getStatus"}')
        assert ref_rpc._recv_frame(b) == b'{"fn": "getStatus"}'


_IMPORT_CHECK = """
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import dynolog_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    dynolog_tpu_torch.__path__, "dynolog_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "dynolog_tpu"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_and_chip_smoke_import_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_CHECK.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules, bad = out.stdout.split(maxsplit=1)
    assert int(n_modules) >= 22 and bad.strip() == "[]"


# The module walk above sees only what importing a module loads; an
# import inside a function body runs when the function does. The source
# scan sees every import statement at any depth, and the dynamic forms.
_BANNED = frozenset({"jax", "jaxlib", "optax", "dynolog_tpu"})
_PORT_SOURCES = sorted(
    str(p.relative_to(REPO))
    for p in [*(REPO / "dynolog_tpu_torch").rglob("*.py"),
              REPO / "chip_smoke.py",
              REPO / "scripts" / "torch_retro_design.py",
              REPO / "scripts" / "stop_call_probe.py"])


def _banned_imports(source: str, filename: str) -> list[str]:
    found = []
    for node in ast.walk(ast.parse(source, filename)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and (getattr(node.func, "attr", None) == "import_module"
                   or getattr(node.func, "id", None) == "__import__")):
            names = [node.args[0].value]
        found += [f"{filename}:{node.lineno} {n}" for n in names
                  if n.split(".")[0] in _BANNED]
    return found


@pytest.mark.parametrize("relpath", _PORT_SOURCES)
def test_port_source_imports_no_jax_at_any_depth(relpath):
    source = (REPO / relpath).read_text(encoding="utf-8")
    assert _banned_imports(source, relpath) == []


def test_source_scan_finds_function_local_imports():
    source = (
        "import dynolog_tpu_torch.fleet\n"
        "from dynolog_tpu_torch.utils import rpc\n"
        "def f():\n"
        "    from dynolog_tpu.fleet import trace_report\n"
        "    class C:\n"
        "        def g(self):\n"
        "            import optax, jax.numpy\n"
        "    importlib.import_module('jaxlib.xla_client')\n"
        "    return __import__('dynolog_tpu')\n")
    assert _banned_imports(source, "m.py") == [
        "m.py:4 dynolog_tpu.fleet", "m.py:8 jaxlib.xla_client",
        "m.py:9 dynolog_tpu", "m.py:7 optax", "m.py:7 jax.numpy"]
    assert len(_PORT_SOURCES) >= 25
