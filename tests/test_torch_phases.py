"""Phase attribution through the port's client shim, held to the
reference shim on the same scenarios (tests/test_phases.py):

  * `phase()` annotations -> the daemon's tagstack -> `getPhases` and
    `dyno phases`, with the nested slices, the snapshot reset and an
    open phase, for both shims against their own daemon;
  * the 'phas' datagrams and the manifest's phase spans, byte for byte
    against the reference on a fake clock;
  * re-registration after a daemon restart replays open phases with
    their original stamps;
  * the `phases:` tracks that trace_report builds from a torch
    manifest, against the reference's report;
  * fleetstatus flagging the host whose `step` phase (the name
    run_annotated_loop gives it) burns a core, with a live torch client
    annotating on that host.
"""

import json
import random
import shutil
import subprocess
import time

import pytest
import torch

from dynolog_tpu_torch.utils.rpc import DynoClient
from torch_control_util import (
    FakeClock,
    Sent,
    daemon,
    shims,
    short_sock_dir,
    spawn_daemon,
    stop_daemon,
    wait_for,
)


def _attribution(client_cls, port, cli_bin):
    """tests/test_phases.py:55's scenario on one shim; returns what the
    daemon attributed."""
    c = client_cls(job_id="ph", poll_interval_s=5.0,
                   metrics_interval_s=3600)
    c.start()
    try:
        with c.phase("epoch"):
            time.sleep(0.1)
            with c.phase("step"):
                time.sleep(0.2)
        time.sleep(0.3)  # the datagrams land

        rpc = DynoClient(port=port)
        procs = {p["pid"]: p for p in rpc.call("getPhases")["processes"]}
        assert c.pid in procs, procs
        mine = procs[c.pid]
        by_stack = {tuple(p["stack"]): p["ms"] for p in mine["phases"]}

        # The snapshot reset the window.
        again = [p for p in rpc.call("getPhases")["processes"]
                 if p["pid"] == c.pid]

        # An open phase attributes up to the query and shows in
        # open_stack.
        c._send_phase("push", "checkpoint")
        time.sleep(0.25)
        mine3 = next(p for p in rpc.call("getPhases")["processes"]
                     if p["pid"] == c.pid)
        ck = {tuple(p["stack"]): p["ms"] for p in mine3["phases"]}
        c._send_phase("pop", "checkpoint")

        with c.phase("render"):
            time.sleep(0.05)
        time.sleep(0.2)
        out = subprocess.run(
            [str(cli_bin), "--port", str(port), "phases"],
            capture_output=True, text=True, timeout=10)
        return {
            "by_stack": by_stack, "open_stack": mine["open_stack"],
            "reset": not again or not again[0]["phases"],
            "open_stack_3": mine3["open_stack"], "ck": ck,
            "cli": out, "pid": c.pid,
        }
    finally:
        c.stop()


def test_phase_attribution_end_to_end(daemon_bin, monkeypatch, cli_bin):
    """Both shims against a daemon each, held to the reference's windows:
    ~100 ms of bare `epoch`, ~200 ms of `epoch>step` (60-300, 150-400),
    an open `checkpoint` of ~250 ms (150-600)."""
    for name, cls in shims():
        with daemon(daemon_bin, monkeypatch) as d:
            got = _attribution(cls, d["port"], cli_bin)
        by_stack = got["by_stack"]
        assert 60 <= by_stack[("epoch",)] <= 300, (name, by_stack)
        assert 150 <= by_stack[("epoch", "step")] <= 400, (name, by_stack)
        assert got["open_stack"] == [], name
        assert got["reset"], name
        assert got["open_stack_3"] == ["checkpoint"], name
        assert 150 <= got["ck"][("checkpoint",)] <= 600, (name, got["ck"])
        assert got["cli"].returncode == 0, got["cli"].stderr
        assert f"pid {got['pid']}" in got["cli"].stdout, name
        assert "render" in got["cli"].stdout, name


def _phase_script(c):
    """Nested phases, a pop that closes an inner frame left open, a phase
    left by an exception, and one left open. Returns the contexts left
    open: one that is collected runs its pop."""
    with c.phase("epoch"):
        with c.phase("step"):
            with c.phase("input"):
                pass
    outer = c.phase("a")
    outer.__enter__()
    inner = c.phase("b")
    inner.__enter__()
    outer.__exit__(None, None, None)  # closes `a` and `b` above it
    with pytest.raises(ValueError):
        with c.phase("eval"):
            raise ValueError("inside a phase")
    ckpt = c.phase("checkpoint")
    ckpt.__enter__()
    return inner, ckpt


@pytest.fixture
def fake_clock_shims(monkeypatch):
    """Both shims, each on a fake clock from the same epoch, their
    clients' sends recorded (no daemon)."""
    import dynolog_tpu.client.shim as jax_shim
    import dynolog_tpu_torch.client.shim as torch_shim
    sock_dir = short_sock_dir(monkeypatch)
    made = []
    for name, cls in shims():
        mod = torch_shim if name == "torch" else jax_shim
        monkeypatch.setattr(mod, "time", FakeClock())
        c = cls(job_id="ph")
        made.append((name, c, Sent(c)))
    yield made
    for _, c, _ in made:
        c._fabric.close()
    shutil.rmtree(sock_dir, ignore_errors=True)


def test_phase_datagrams_and_spans_match_reference(fake_clock_shims):
    """Same calls on the same clock: the 'phas' datagrams are the
    reference's bytes, and so are the manifest's phase spans (closed
    ring plus the open stack) and the open phases a re-registration
    replays."""
    out, left_open = {}, []
    for name, c, sent in fake_clock_shims:
        left_open.append(_phase_script(c))
        spans = c._export_phase_spans()
        c._register()
        replay = sent.of_type("phas")[-1:]
        out[name] = (sent.of_type("phas"), spans, replay)
    torch_phas, torch_spans, torch_replay = out["torch"]
    jax_phas, jax_spans, jax_replay = out["jax"]
    assert len(torch_phas) == 13  # 7 pushes, 5 pops, the replayed push
    assert torch_phas == jax_phas
    assert torch_spans == jax_spans
    assert [s["name"] for s in torch_spans] == [
        "input", "step", "epoch", "a", "eval", "checkpoint"]
    assert torch_spans[-1]["open"] and torch_spans[-1]["t_end"] is None
    # The replay re-sends the open `checkpoint` with its first stamp.
    replayed = json.loads(torch_replay[0][4:])
    assert replayed["op"] == "push" and replayed["phase"] == "checkpoint"
    assert replayed["t"] == torch_spans[-1]["t_start"]
    assert torch_replay == jax_replay


def _reregistration(client_cls, daemon_bin, d):
    """tests/test_phases.py:245's scenario; returns (wall_ms of the
    replayed phase, ms since its push, the client's counters)."""
    c = client_cls(job_id="phre", poll_interval_s=0.2,
                   metrics_interval_s=3600, backoff_cap_s=0.5)
    c.start()
    try:
        ctx = c.phase("ckpt")
        ctx.__enter__()
        t_push = time.time()
        time.sleep(0.3)
        stop_daemon(d["proc"])
        d["proc"], d["port"] = spawn_daemon(daemon_bin)

        def replayed():
            procs = [p for p in DynoClient(port=d["port"]).call(
                "getPhases")["processes"] if p["pid"] == c.pid]
            return procs and procs[0]["open_stack"] == ["ckpt"] and procs[0]

        mine = wait_for(replayed, 10, "the open phase replayed")
        elapsed_ms = (time.time() - t_push) * 1e3
        ctx.__exit__(None, None, None)
        by_leaf = {tuple(p["stack"])[-1]: p for p in mine["phases"]}
        return by_leaf["ckpt"]["wall_ms"], elapsed_ms, c.spans.counters()
    finally:
        c.stop()


def test_phase_reregistration_repushes_open_phases(daemon_bin, monkeypatch):
    """A daemon bounce mid-phase: each shim re-registers and replays the
    open `ckpt` with its original stamp, so the new daemon attributes
    the time since that push (the reference's bound: at least half)."""
    for name, cls in shims():
        with daemon(daemon_bin, monkeypatch) as d:
            wall_ms, elapsed_ms, counters = _reregistration(
                cls, daemon_bin, d)
        assert wall_ms >= 0.5 * elapsed_ms, (name, wall_ms, elapsed_ms)
        assert counters.get("reregistrations", 0) >= 1, (name, counters)


def test_trace_report_renders_phase_tracks_from_torch_manifest(
        tmp_path, fake_clock_shims):
    """Phase spans from the torch shim's manifest become `phases:<host>`
    duration tracks, the same events the reference report builds from
    the same manifests."""
    from dynolog_tpu.fleet.trace_report import build_report as jax_report
    from dynolog_tpu_torch.fleet.trace_report import build_report

    _, c, _ = fake_clock_shims[0]
    with c.phase("step"):
        with c.phase("input"):
            pass
    dangling = c.phase("danglingopen")
    dangling.__enter__()
    spans = c._export_phase_spans()
    t0 = spans[0]["t_start"]
    manifests = []
    for h in ("h0_1", "h1_2"):
        d = tmp_path / h
        d.mkdir()
        manifests.append({
            "_dir": str(d), "hostname": h.split("_")[0],
            "trace_timing": {"trace_start": t0, "trace_stop": t0 + 1},
            "phase_spans": spans})

    def phase_events(report):
        return [e for e in report["traceEvents"] if e.get("pid", 0) >= 2]

    report = build_report(manifests)
    events = report["traceEvents"]
    names = {e["args"]["name"] for e in events
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert {"phases:h0_1", "phases:h1_2"} <= names
    xs = [e for e in events if e.get("ph") == "X" and e["pid"] >= 2]
    assert {e["name"] for e in xs} == {"step", "input"}  # no open span
    inp = next(e for e in xs if e["name"] == "input")
    assert inp["tid"] == 1 and inp["dur"] == pytest.approx(0.25e6)
    assert report["metadata"]["phase_hosts"] == 2
    assert phase_events(report) == phase_events(jax_report(manifests))


def _host_bound_step(client, stop_at):
    """A tiny CPU train step under run_annotated_loop: its `step` phase
    is what the rule reads, on the shim's own pid."""
    from dynolog_tpu_torch.models.train import run_annotated_loop
    w = torch.randn(32, 32)
    while time.monotonic() < stop_at:
        run_annotated_loop(lambda x: (x @ w).sum(),
                           lambda i: torch.randn(8, 32), 4, client=client)


def test_fleetstatus_flags_host_bound_from_torch_phases(
        daemon_bin, fixture_root, monkeypatch):
    """tests/test_phases.py:354 with a live torch client on the bound
    host: its `step` phases feed that daemon's phase_cpu_util.step
    series beside the reference's injected history, and the port's
    fleetstatus flags exactly that host HOST_BOUND, as the reference's
    fleetstatus does on the same daemons."""
    from dynolog_tpu.fleet import fleetstatus as jax_fleetstatus
    from dynolog_tpu_torch.client import DynologClient
    from dynolog_tpu_torch.fleet import fleetstatus, minifleet

    sock_dir = short_sock_dir(monkeypatch)
    bound = 1
    daemons = minifleet.spawn_daemons(
        daemon_bin, 4, "tphb",
        daemon_args=("--procfs_root", str(fixture_root),
                     "--enable_history_injection",
                     "--phase_cpu_emit_interval_s", "0.2"))
    try:
        rng = random.Random(11)
        now_ms = int(time.time() * 1000)

        def series(base, spread=0.3):
            return [(now_ms - (30 - k) * 1000,
                     base + rng.uniform(-spread, spread))
                    for k in range(30)]

        for i, (_, port) in enumerate(daemons):
            cli = DynoClient(port=port)
            for dev in range(2):
                r = cli.put_history(f"tensorcore_duty_cycle_pct.dev{dev}",
                                    series(8.0))
                assert r.get("added"), r
                r = cli.put_history(f"hbm_util_pct.dev{dev}", series(40.0))
                assert r.get("added"), r
            cpu = 0.95 if i == bound else 0.15
            r = cli.put_history("phase_cpu_util.step",
                                series(cpu, spread=0.02))
            assert r.get("added"), r

        bound_rpc = DynoClient(port=daemons[bound][1])

        def step_samples():
            win = bound_rpc.get_aggregates(
                windows_s=[300], key_prefix="phase_cpu_util.step"
            ).get("windows", {}).get("300", {})
            return sum(s.get("count", 0) for s in win.values())

        client = DynologClient(job_id="hb", daemon_socket=f"tphb{bound}",
                               poll_interval_s=5.0, metrics_interval_s=3600)
        client.start()
        try:
            deadline = time.monotonic() + 15
            while step_samples() <= 30 and time.monotonic() < deadline:
                _host_bound_step(client, time.monotonic() + 0.3)
            mine = [p for p in bound_rpc.call("getPhases")["processes"]
                    if p["pid"] == client.pid]
        finally:
            client.stop()
        # The collector emits what the last interval accumulated one
        # tick later: sweep once the series stops growing.
        n = step_samples()
        while True:
            time.sleep(0.5)
            n, prev = step_samples(), n
            if n == prev:
                break
        assert n > 30, "no phase_cpu_util.step from the shim"
        leaves = {tuple(p["stack"])[-1] for p in mine[0]["phases"]}
        assert {"step", "input"} <= leaves, mine

        hosts = [f"localhost:{p}" for _, p in daemons]
        verdicts = {}
        for name, mod in (("torch", fleetstatus), ("jax", jax_fleetstatus)):
            v = mod.sweep(hosts, window_s=300)
            assert not v["unreachable"] and not v["outliers"], (name, v)
            assert [hb["host"] for hb in v["host_bound_hosts"]] == \
                [hosts[bound]], (name, v["host_bound_hosts"])
            hb = v["host_bound_hosts"][0]
            assert hb["phase"] == "step"
            assert hb["cpu_util"] >= 0.75 and hb["duty_cycle"] <= 20.0
            assert "HOST_BOUND" in mod.render(v)
            csv = ",".join(hosts)
            codes = [mod.main(["--hosts", csv, "--window-s", "300", *extra])
                     for extra in ((), ("--fail-on-outlier",))]
            verdicts[name] = (v["host_bound_hosts"], v["warn"], codes)
        assert verdicts["torch"] == verdicts["jax"]
        assert verdicts["torch"][2] == [0, 1]
    finally:
        minifleet.teardown(daemons, [])
        shutil.rmtree(sock_dir, ignore_errors=True)
