"""Fleet fan-out with the port: unitrace triggering synchronized
captures on N daemons whose clients are the torch shim.

The cases of tests/test_fleet.py, played by the port's minifleet (fake
torch clients: the real shim with the profiler cut out), plus one case
with real captures: two `dynolog_tpu_torch.models.examples transformer`
processes on the CPU, each under its own daemon, gang-traced, reported
and pulled back over RPC. The 64-host case stays with the JAX suite: the
port's fan_out is a copy, held to the reference's bytes by
tests/test_torch_rpc_fanout.py.
"""

import argparse
import glob
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import pytest

from dynolog_tpu_torch.fleet import minifleet, trace_report, unitrace
from dynolog_tpu_torch.utils.rpc import DynoClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def sock_dir(monkeypatch):
    """The fabric's socket dir, fresh per test and short: an AF_UNIX
    path stays under 108 bytes, which pytest's per-test dirs under
    xdist exceed once a client's endpoint name is appended."""
    d = tempfile.mkdtemp(prefix="dtf")
    monkeypatch.setenv("DYNOLOG_TPU_SOCKET_DIR", d)
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _hosts(daemons):
    return ",".join(f"localhost:{p}" for _, p in daemons)


def test_unitrace_two_hosts(daemon_bin, fixture_root, tmp_path, sock_dir):
    daemons, clients = minifleet.spawn(
        daemon_bin, 2, "dtf2",
        daemon_args=("--procfs_root", str(fixture_root)),
        job_id="99", poll_interval_s=0.1, write_fake_trace=True)
    try:
        assert minifleet.wait_registered(daemons)
        log_dir = tmp_path / "traces"
        rc = unitrace.main([
            "--hosts", _hosts(daemons),
            "--job-id", "99",
            "--log-dir", str(log_dir),
            "--duration-ms", "300",
            "--start-time-delay-s", "1",
        ])
        assert rc == 0
        assert minifleet.wait_captures(clients)
        traces = glob.glob(str(log_dir / "**" / "*.pt.trace.json"),
                           recursive=True)
        assert len(traces) == 2  # one per fake host
    finally:
        minifleet.teardown(daemons, clients)


def test_unitrace_report_merged_timeline(daemon_bin, fixture_root,
                                         tmp_path, sock_dir, capsys):
    """Gang trace across 3 fake torch hosts, then `--report` merges every
    host's dynolog_manifest.json into ONE Chrome-trace timeline — and
    finds each host's .pt.trace.json at once instead of waiting out
    --report-wait-s."""
    n_hosts = 3
    daemons, clients = minifleet.spawn(
        daemon_bin, n_hosts, "dtfrep",
        daemon_args=("--procfs_root", str(fixture_root)),
        job_id="rep", poll_interval_s=0.1, write_fake_trace=True)
    try:
        assert minifleet.wait_registered(daemons)
        log_dir = tmp_path / "traces"
        args = unitrace.build_parser().parse_args([
            "--hosts", _hosts(daemons),
            "--job-id", "rep",
            "--log-dir", str(log_dir),
            "--duration-ms", "300",
            "--start-time-delay-s", "1",
            "--report",
            "--report-wait-s", "30",
        ])
        t0 = time.monotonic()
        out = unitrace.run(args)
        elapsed = time.monotonic() - t0
        assert out["ok"] == n_hosts, out["results"]
        assert minifleet.wait_captures(clients)
        # Delay + window + delivery, far below the 30 s artifact wait.
        assert elapsed < 15, elapsed

        path = out["report_path"]
        assert path, "unitrace --report produced no report"
        with open(path) as f:
            report = json.load(f)
        md = report["metadata"]
        assert md["hosts"] == n_hosts
        assert md["capture_start_skew_ms"] >= 0
        assert md["deliver_ms_max"] > 0
        arts = md["artifacts"]
        assert len(arts) == n_hosts
        assert all(a["path"].endswith(".pt.trace.json")
                   and a["source"] == "export" for a in arts)

        xs = [e for e in report["traceEvents"] if e["ph"] == "X"]
        pids = {e["pid"] for e in xs}
        assert len(pids) == n_hosts
        for pid in pids:
            names = {e["name"] for e in xs if e["pid"] == pid}
            assert names >= {"register", "poll", "deliver", "capture"}, (
                pid, names)
        labels = {e["args"]["name"] for e in report["traceEvents"]
                  if e["ph"] == "M"}
        assert len(labels) == n_hosts
        assert "merged trace-delivery timeline" in capsys.readouterr().out
    finally:
        minifleet.teardown(daemons, clients)


def test_unitrace_synchronized_window_mini_fleet(daemon_bin, fixture_root,
                                                 tmp_path, sock_dir,
                                                 capsys):
    """Every capture's trace_start lands inside a tight window around
    the broadcast start_time_ms, and the windows mutually overlap."""
    n_hosts = 8
    daemons, clients = minifleet.spawn(
        daemon_bin, n_hosts, "dtfsync",
        daemon_args=("--procfs_root", str(fixture_root)),
        job_id="77", poll_interval_s=0.1)
    try:
        assert minifleet.wait_registered(daemons)
        args = unitrace.build_parser().parse_args([
            "--hosts", _hosts(daemons),
            "--job-id", "77",
            "--log-dir", str(tmp_path / "traces"),
            "--duration-ms", "200",
            "--start-time-delay-s", "2",
        ])
        out = unitrace.run(args)
        assert out["ok"] == n_hosts, out["results"]
        start_s = out["start_time_ms"] / 1000.0
        assert minifleet.wait_captures(clients)

        tol_s = 0.75
        for c in clients:
            t = c.trace_timing["trace_start"]
            assert start_s - 0.05 <= t <= start_s + tol_s, (t, start_s)
        windows = minifleet.capture_windows(clients)
        assert len(windows) == n_hosts
        assert minifleet.windows_intersect(windows), windows

        printed = capsys.readouterr().out
        assert "capture manifest:" in printed
        assert "start_time_ms=" in printed
        for c in clients:
            assert str(c.pid) in printed
        assert f"{n_hosts}/{n_hosts} hosts triggered" in printed
    finally:
        minifleet.teardown(daemons, clients)


def test_unitrace_chaos_dead_and_dying_hosts(daemon_bin, fixture_root,
                                             tmp_path, sock_dir, capsys):
    """Two of 8 daemons are dead before the trigger (reported FAILED by
    name, rc 1); one more dies mid-capture and its client still
    completes — the daemon is out of the data path once the config is
    handed off. The surviving captures mutually overlap. (The reference
    case runs 16 hosts; 8 keep the same three groups.)"""
    n_hosts = 8
    dead = {3, 6}
    dying = 0
    daemons, clients = minifleet.spawn(
        daemon_bin, n_hosts, "dtfchaos",
        daemon_args=("--procfs_root", str(fixture_root)),
        job_id="chaos", poll_interval_s=0.3)
    try:
        assert minifleet.wait_registered(daemons, timeout_s=30)
        for i in dead:
            minifleet.kill_daemon(daemons, i)
        host_of = {i: f"localhost:{p}" for i, (_, p) in enumerate(daemons)}
        args = unitrace.build_parser().parse_args([
            "--hosts", ",".join(host_of[i] for i in range(n_hosts)),
            "--job-id", "chaos",
            "--log-dir", str(tmp_path / "traces"),
            "--duration-ms", "1500",
            "--start-time-delay-s", "2",
            "--rpc-timeout-s", "3",
        ])
        out = unitrace.run(args)
        failed_hosts = {r["host"] for r in out["results"] if not r["ok"]}
        assert failed_hosts == {host_of[i] for i in dead}, out["results"]
        assert out["ok"] == n_hosts - len(dead)
        start_s = out["start_time_ms"] / 1000.0
        printed = capsys.readouterr().out
        for i in dead:
            assert f"{host_of[i]}: FAILED" in printed
        assert f"{n_hosts - len(dead)}/{n_hosts} hosts triggered" in printed

        wake = start_s + 0.3 - time.time()
        if wake > 0:
            time.sleep(wake)
        minifleet.kill_daemon(daemons, dying)

        survivors = [c for i, c in enumerate(clients) if i not in dead]
        assert minifleet.wait_captures(survivors, timeout_s=30)
        assert clients[dying].captures_completed == 1
        windows = minifleet.capture_windows(survivors)
        assert len(windows) == n_hosts - len(dead)
        assert minifleet.windows_intersect(windows), windows
        for i in dead:
            assert clients[i].captures_completed == 0
    finally:
        minifleet.teardown(daemons, clients)


def test_unitrace_reports_failure_for_unreachable_host(capsys):
    rc = unitrace.main([
        "--hosts", "localhost:1",
        "--job-id", "1",
        "--rpc-timeout-s", "1",
        "--start-time-delay-s", "0",
    ])
    assert rc == 1
    out = capsys.readouterr().out
    assert "FAILED" in out
    assert "0/1 hosts" in out


def test_build_config_iteration_mode():
    ns = argparse.Namespace(
        log_dir="/d", duration_ms=500, host_tracer_level=2,
        python_tracer=False, iterations=5, iteration_roundup=10)
    cfg = json.loads(unitrace.build_config(ns, None))
    assert cfg["type"] == "xplane"  # the on-demand capture type
    assert cfg["iterations"] == 5
    assert cfg["iteration_roundup"] == 10
    assert "start_time_ms" not in cfg


class _Run:
    def __init__(self, returncode=0, stdout="", stderr=""):
        self.returncode, self.stdout, self.stderr = (
            returncode, stdout, stderr)


def test_host_discovery_slurm_and_gcloud(monkeypatch):
    """The schedulers' output formats (stubbed binaries: squeue -h -o
    %N, scontrol show hostnames, gcloud's networkEndpoints JSON)."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        if cmd[0] == "squeue":
            return _Run(stdout="gpu-host[1-3]\n")
        if cmd[0] == "scontrol":
            assert cmd[:4] == ["scontrol", "show", "hostnames",
                               "gpu-host[1-3]"]
            return _Run(stdout="gpu-host1\ngpu-host2\ngpu-host3\n")
        if cmd[0] == "gcloud":
            return _Run(stdout=json.dumps({"networkEndpoints": [
                {"ipAddress": "10.0.0.1"}, {"ipAddress": "10.0.0.2"}]}))
        raise AssertionError(cmd)

    monkeypatch.setattr(unitrace.subprocess, "run", fake_run)
    assert unitrace.hosts_from_slurm("77") == [
        "gpu-host1", "gpu-host2", "gpu-host3"]
    assert unitrace.hosts_from_gcloud("my-pod", "us-central2-b") == [
        "10.0.0.1", "10.0.0.2"]
    assert any("--zone" in c for c in calls if c[0] == "gcloud")

    monkeypatch.setattr(unitrace.subprocess, "run", lambda cmd, **kw: _Run(
        1, stderr="slurm_load_jobs error"))
    with pytest.raises(RuntimeError, match="slurm_load_jobs"):
        unitrace.hosts_from_slurm("77")

    def scontrol_fails(cmd, **kw):
        if cmd[0] == "squeue":
            return _Run(stdout="gpu-host[1-3]\n")
        return _Run(1, stderr="invalid hostlist")

    monkeypatch.setattr(unitrace.subprocess, "run", scontrol_fails)
    with pytest.raises(RuntimeError, match="invalid hostlist"):
        unitrace.hosts_from_slurm("77")


def test_main_reports_discovery_failure(capsys, monkeypatch):
    def no_such_binary(cmd, **kw):
        raise FileNotFoundError(f"No such file or directory: {cmd[0]!r}")

    monkeypatch.setattr(unitrace.subprocess, "run", no_such_binary)
    rc = unitrace.main(["--slurm-job-id", "1", "--start-time-delay-s", "0"])
    assert rc == 2
    assert "host discovery failed" in capsys.readouterr().err


def test_resolve_hosts_precedence(tmp_path):
    hostfile = tmp_path / "hosts"
    hostfile.write_text("h1\n\n h2 \n")
    ns = argparse.Namespace(
        hosts="", hostfile=str(hostfile), slurm_job_id="", tpu_name="")
    assert unitrace.resolve_hosts(ns) == ["h1", "h2"]
    ns = argparse.Namespace(
        hosts="a:1,b:2", hostfile="", slurm_job_id="", tpu_name="")
    assert unitrace.resolve_hosts(ns) == ["a:1", "b:2"]
    ns = argparse.Namespace(
        hosts="x:9", hostfile=str(hostfile), slurm_job_id="ignored",
        tpu_name="ignored")
    assert unitrace.resolve_hosts(ns) == ["x:9"]


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_real_torch_captures_reported_and_pulled(daemon_bin, fixture_root,
                                                 tmp_path, sock_dir):
    """Two CPU training processes (the port's example transformer), each
    registered to its own daemon: `unitrace --report` gathers two real
    .pt.trace.json files and two manifests, and pull_artifacts brings
    back files byte-identical to the daemon-committed
    streamed.pt.trace.json, under that name."""
    daemons = minifleet.spawn_daemons(
        daemon_bin, 2, "dtfreal",
        daemon_args=("--procfs_root", str(fixture_root)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               DYNOLOG_TPU_SOCKET_DIR=sock_dir)
    workers = []
    try:
        for i in range(2):
            workers.append(subprocess.Popen(
                [sys.executable, "-m", "dynolog_tpu_torch.models.examples",
                 "transformer", "--device", "cpu", "--steps", "100000",
                 "--job-id", "real"],
                env=dict(env, DYNOLOG_TPU_SOCKET=f"dtfreal{i}"),
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                cwd=REPO))

        def stepping():
            # The loop's "step" phase annotations reach each daemon once
            # the worker trains, so the capture starts inside step().
            return all('"step"' in json.dumps(DynoClient(
                port=port).get_phases()) for _, port in daemons)

        deadline = time.monotonic() + 30
        while not stepping():
            assert time.monotonic() < deadline, "workers never stepped"
            assert all(w.poll() is None for w in workers)
            time.sleep(0.2)

        log_dir = tmp_path / "traces"
        args = unitrace.build_parser().parse_args([
            "--hosts", _hosts(daemons),
            "--job-id", "real",
            "--log-dir", str(log_dir),
            "--duration-ms", "300",
            "--start-time-delay-s", "1",
            "--report",
            "--report-wait-s", "20",
        ])
        out = unitrace.run(args)
        assert out["ok"] == 2, out["results"]
        with open(out["report_path"]) as f:
            md = json.load(f)["metadata"]
        assert md["hosts"] == 2
        arts = md["artifacts"]
        assert [a["source"] for a in arts] == ["streamed", "streamed"]
        committed = {}
        for a in arts:
            assert os.path.basename(a["path"]) == "streamed.pt.trace.json"
            with open(a["path"]) as f:
                events = json.load(f)["traceEvents"]
            assert any(str(e.get("name", "")).startswith("aten::")
                       for e in events)
            capture_dir = os.path.dirname(a["path"])
            exported = [p for p in glob.glob(
                os.path.join(capture_dir, "*.pt.trace.json"))
                if p != a["path"]]
            assert len(exported) == 1
            assert _sha256(exported[0]) == _sha256(a["path"])
            assert os.path.isfile(os.path.join(
                capture_dir, trace_report.MANIFEST_NAME))
            committed[os.path.basename(capture_dir)] = _sha256(a["path"])

        pulled_dir = tmp_path / "pulled"
        assert unitrace.pull_artifacts(out["hosts"], str(pulled_dir)) == 2
        pulled = {os.path.basename(os.path.dirname(p)): _sha256(p)
                  for p in glob.glob(str(pulled_dir / "*" / "*"))}
        assert set(os.listdir(pulled_dir / next(iter(committed)))) == {
            "streamed.pt.trace.json"}
        assert pulled == committed
    finally:
        for w in workers:
            w.send_signal(signal.SIGTERM)
        for w in workers:
            try:
                w.wait(timeout=10)
            except subprocess.TimeoutExpired:
                w.kill()
                w.wait()
        minifleet.teardown(daemons, [])
