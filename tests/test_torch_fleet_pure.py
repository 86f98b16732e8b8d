"""The port's fleet modules against the JAX package's, on the same inputs.

No daemon: seeded samples, aggregate dicts and manifests go through
both packages' pure functions. Every comparison is exact — the port's
fleet modules are copies, so any difference is a fault:

  sketch       merged bucket counts, wire JSON and quantiles equal
  fleetstatus  robust z, host scalars, the whole sweep verdict (JSON)
               and its rendered table equal
  trace_report the merged report equal once each artifact path is
               mapped to its capture dir (the port finds .pt.trace.json
               where the reference finds .xplane.pb)
  unitrace     build_config byte-identical
  eventlog     chrome_instants and merge_into_report byte-identical
  minifleet    the seeded-topology and ICI-ring helpers return equal
               values (ring_link_series with and without an ici_link
               fault armed), read_retro_window decodes both encodings
"""

import argparse
import copy
import gzip
import json
import os

import numpy as np
import pytest

from dynolog_tpu.fleet import eventlog as j_eventlog
from dynolog_tpu.fleet import fleetstatus as j_fleetstatus
from dynolog_tpu.fleet import minifleet as j_minifleet
from dynolog_tpu.fleet import sketch as j_sketch
from dynolog_tpu.fleet import trace_report as j_report
from dynolog_tpu.fleet import unitrace as j_unitrace
from dynolog_tpu_torch.fleet import eventlog as t_eventlog
from dynolog_tpu_torch.fleet import fleetstatus as t_fleetstatus
from dynolog_tpu_torch.fleet import minifleet as t_minifleet
from dynolog_tpu_torch.fleet import sketch as t_sketch
from dynolog_tpu_torch.fleet import trace_report as t_report
from dynolog_tpu_torch.fleet import unitrace as t_unitrace

SEEDS = [0, 1, 2]
QS = [0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0]


def _dumps(obj) -> str:
    return json.dumps(obj, sort_keys=True)


def _streams(seed):
    """Per-host sample streams: positive, signed, with zeros, heavy tail."""
    rng = np.random.default_rng(seed)
    return [
        rng.lognormal(3.0, 1.0, 400).tolist(),
        (rng.normal(0.0, 50.0, 300)).tolist(),
        [0.0] * 20 + rng.uniform(0, 100, 200).tolist(),
        (rng.pareto(1.5, 500) * 10).tolist(),
    ]


@pytest.mark.parametrize("seed", SEEDS)
def test_sketch_merge_and_quantiles_equal(seed):
    out = {}
    for name, mod in (("ref", j_sketch), ("port", t_sketch)):
        sketches = []
        for stream in _streams(seed):
            sk = mod.QuantileSketch()
            for v in stream:
                sk.add(v)
            sketches.append(sk)
        merged = mod.QuantileSketch()
        for sk in sketches:
            assert merged.merge(sk)
        wire = [sk.to_json() for sk in sketches]
        all_merged = mod.merge_all(wire)
        out[name] = {
            "wire": wire,
            "merged": merged.to_json(),
            "merged_q": [merged.quantile(q) for q in QS],
            "merge_all": all_merged.to_json(),
            "merge_all_q": [all_merged.quantile(q) for q in QS],
            "mean": merged.mean,
            "buckets": merged.bucket_count(),
        }
    assert out["port"] == out["ref"]
    # The wire format crosses between the packages both ways.
    for payload in out["ref"]["wire"]:
        assert t_sketch.QuantileSketch.from_json(payload).to_json() == payload
    assert j_sketch.QuantileSketch.from_json(
        out["port"]["merged"]).to_json() == out["ref"]["merged"]


def test_sketch_collapse_and_malformed_equal():
    values = np.random.default_rng(5).lognormal(0.0, 6.0, 3000).tolist()
    for mod in (j_sketch, t_sketch):
        sk = mod.QuantileSketch(max_buckets=64)
        for v in values:
            sk.add(v)
        assert sk.bucket_count() <= 64
    ref = j_sketch.QuantileSketch(max_buckets=64)
    port = t_sketch.QuantileSketch(max_buckets=64)
    for v in values:
        ref.add(v)
        port.add(v)
    assert port.to_json() == ref.to_json()
    bad = [{"a": 2.0, "c": 1}, {"a": 0.01, "c": -1},
           {"a": 0.01, "c": 2, "mn": 1.0}, {"a": 0.01, "c": 1, "mn": 1.0,
                                            "mx": 1.0, "pi": [1],
                                            "pc": []}, "x"]
    for payload in bad:
        assert t_sketch.QuantileSketch.from_json(payload) is None
        assert j_sketch.QuantileSketch.from_json(payload) is None
    assert t_sketch.merge_all(bad) is None


@pytest.mark.parametrize("seed", SEEDS)
def test_robust_z_scores_equal(seed):
    rng = np.random.default_rng(seed)
    cases = [rng.normal(50, 5, 16).tolist(),
             [10.0] * 7 + [2.0],           # MAD 0: mean-abs-dev fallback
             [3.0] * 5,                    # flat fleet
             [1.0], []]
    for xs in cases:
        assert (_dumps(t_fleetstatus.robust_z_scores(xs))
                == _dumps(j_fleetstatus.robust_z_scores(xs)))


def _summary(rng, center, count=30):
    vals = rng.normal(center, center * 0.03 + 0.1, count)
    return {"count": count, "mean": float(vals.mean()),
            "min": float(vals.min()), "max": float(vals.max()),
            "p50": float(np.median(vals)),
            "p95": float(np.quantile(vals, 0.95)),
            "p99": float(np.quantile(vals, 0.99)), "slope_per_s": 0.0}


def _wire(mod, values):
    sk = mod.QuantileSketch()
    for v in values:
        sk.add(float(v))
    return sk.to_json()


def _ring_block(index, size, bw_link0, bw_link1):
    links = []
    for k, bw in ((0, bw_link0), (1, bw_link1)):
        links.append({"link": k, "edge": (index - 1 + size) % size
                      if k == 0 else index, "stalls_per_s": 0.0,
                      "tx_bytes_per_s": bw, "rx_bytes_per_s": bw})
    return {"topology": "ring", "size": size, "index": index,
            "links": links}


def _fleet_records(seed, dark):
    """fetch_all-shaped records for an 8-host fleet on an 8-host ICI
    ring: a duty-cycle straggler, a host-bound host, a degraded
    collector, a durable tier evicting, one daemon whose aggregates
    failed, and one slow ring edge. With ``dark`` host 7 is unreachable,
    which leaves the ring's edges unscorable."""
    rng = np.random.default_rng(seed)
    hosts = [f"h{i}:1778" for i in range(8)]
    # Edge e joins host e's link 1 and host e+1's link 0; edge 1 runs
    # at a fifth of the others on both endpoints.
    rates = [1e6 * (1 + 0.01 * e) for e in range(8)]
    rates[1] = 2e5
    records = []
    for i, host in enumerate(hosts):
        ici = _ring_block(i, 8, rates[(i - 1) % 8], rates[i])
        if i == 7 and dark:
            records.append({"host": host, "ok": False,
                            "error": "ConnectionRefusedError: refused",
                            "status_ok": False, "degraded": [],
                            "storage": None, "attempts": 3,
                            "elapsed_s": 0.5})
            continue
        if i == 6:
            records.append({"host": host, "ok": False,
                            "error": "RuntimeError: busy",
                            "status_ok": True, "degraded": [],
                            "storage": None, "attempts": 1,
                            "elapsed_s": 0.1, "ici": ici})
            continue
        duty = 20.0 if i == 2 else 90.0 + i
        window = {}
        sketches = {}
        for dev in range(2):
            window[f"tensorcore_duty_cycle_pct.dev{dev}"] = _summary(
                rng, duty)
            window[f"hbm_util_pct.dev{dev}"] = _summary(rng, 60.0)
            window[f"ici_tx_bytes_per_s.dev{dev}"] = _summary(rng, 1e6)
            window[f"ici_rx_bytes_per_s.dev{dev}"] = _summary(
                rng, 4e5 if i == 4 else 1e6)
            sketches[f"tensorcore_duty_cycle_pct.dev{dev}"] = _wire(
                j_sketch, rng.normal(duty, 2.0, 40))
        if i == 5:
            window["phase_cpu_util.step"] = _summary(rng, 0.95)
            for dev in range(2):
                window[f"tensorcore_duty_cycle_pct.dev{dev}"]["p50"] = 5.0
        rec = {"host": host, "ok": True, "window": window,
               "sketches": sketches, "attempts": 1, "elapsed_s": 0.01,
               "degraded": [], "storage": "evicting" if i == 1 else None}
        if i == 3:
            rec["degraded"] = [{"collector": "tpu", "state": "quarantined",
                                "consecutive_failures": 4, "restarts": 2,
                                "last_error": "poll timeout"}]
        rec["ici"] = ici
        records.append(rec)
    return hosts, records


@pytest.mark.parametrize("seed", SEEDS)
def test_host_scalars_equal(seed):
    _, records = _fleet_records(seed, dark=False)
    for rec in records:
        if rec["ok"]:
            w = rec["window"]
            metrics = j_fleetstatus.DEFAULT_WATCHLIST
            assert (_dumps(t_fleetstatus.host_scalars(w, metrics))
                    == _dumps(j_fleetstatus.host_scalars(w, metrics)))
            assert (t_fleetstatus.host_bound_check(w)
                    == j_fleetstatus.host_bound_check(w))


@pytest.mark.parametrize("dark", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_sweep_verdict_and_render_equal(monkeypatch, seed, dark):
    hosts, records = _fleet_records(seed, dark)
    for mod in (j_fleetstatus, t_fleetstatus):
        monkeypatch.setattr(
            mod, "fetch_all",
            lambda *a, **k: copy.deepcopy(records))
    ref = j_fleetstatus.sweep(hosts, window_s=300)
    port = t_fleetstatus.sweep(hosts, window_s=300)
    assert _dumps(port) == _dumps(ref)
    assert t_fleetstatus.render(port) == j_fleetstatus.render(ref)
    # The fixture reaches every verdict branch the render prints.
    text = t_fleetstatus.render(port)
    words = ["STRAGGLER", "AGG-FAILED", "DEGRADED", "HOST_BOUND",
             "STORAGE", "fleet tensorcore_duty_cycle_pct"]
    words += (["UNREACHABLE", "link scoring: host_only_fallback"] if dark
              else ["LINK_BOUND h1:1778<->h2:1778:link1"])
    for word in words:
        assert word in text, word
    assert (t_unitrace.diff_hint_from_health(port)
            == j_unitrace.diff_hint_from_health(ref))


def test_render_tree_verdict_equal():
    verdict = {"source": "tree", "window_s": 60, "z_threshold": 3.5,
               "hosts": ["a:1", "b:1"], "unreachable": [],
               "metrics": {}, "outliers": [], "ok": True,
               "fidelity": {"b:1": "digest", "a:1": "scalar"},
               "relay": {"sheds": 2, "splits": 1},
               "link_scoring": {"status": "host_only_fallback",
                                "reason": "incomplete_topology",
                                "missing_hosts": ["b:1"]}}
    assert (t_fleetstatus.render(verdict)
            == j_fleetstatus.render(verdict))
    assert (t_fleetstatus.parse_metrics("a,b:high,c:low")
            == j_fleetstatus.parse_metrics("a,b:high,c:low"))


def _manifests(seed):
    rng = np.random.default_rng(seed)
    t0 = 1_760_000_000.0
    out = []
    for i in range(3):
        start = t0 + 3.0 + float(rng.uniform(0, 0.05))
        recv = t0 + float(rng.uniform(0, 0.01))
        m = {"pid": 100 + i, "hostname": f"host{i}",
             "trace_timing": {"config_received": recv,
                              "delivery": "push" if i else "poll",
                              "trace_start": start,
                              "trace_stop": start + 0.5,
                              "export_done": start + 0.9,
                              "stream_commit": start + 1.2},
             "phase_spans": [
                 {"name": "step", "t_start": start + k * 0.1,
                  "t_end": start + k * 0.1 + 0.08, "depth": 0}
                 for k in range(3)] + [
                 {"name": "step", "t_start": start + 0.4, "t_end": None,
                  "depth": 0, "open": True}],
             "op_stats": [
                 {"name": "aten::mm", "count": 30,
                  "total_ms": float(rng.uniform(5, 9)) * (3 if i == 1
                                                          else 1)},
                 {"name": "nccl:all_reduce", "count": 2,
                  "total_ms": float(rng.uniform(1, 2)),
                  "collective": True, "cpu_ms": 0.3}]}
        if i != 2:  # host2 predates the span recorder
            m["spans"] = [
                {"name": "register", "t_start": t0 - 5, "t_end": t0 - 4.99,
                 "dur_ms": 10.0, "ok": True},
                {"name": "deliver", "t_start": recv, "t_end": start,
                 "dur_ms": round((start - recv) * 1e3, 3)}]
        out.append(m)
    return out


def _lay_out(root, manifests, streamed, exported):
    """Capture dirs as the daemon leaves them: the manifest plus, for
    hosts 0 and 1, the artifact (host 0 streamed, host 1 exported only);
    host 2 has none."""
    laid = []
    for i, m in enumerate(manifests):
        d = root / f"host{i}_{m['pid']}"
        d.mkdir(parents=True)
        (d / j_report.MANIFEST_NAME).write_text(json.dumps(m))
        if i == 0:
            (d / streamed).write_text("{}")
            (d / f"host{i}_{m['pid']}{exported}").write_text("{}")
        elif i == 1:
            (d / f"host{i}_{m['pid']}{exported}").write_text("{}")
        laid.append(str(d))
    retro = root / "retro_host1-7"
    retro.mkdir()
    (retro / j_report.RETRO_MANIFEST_NAME).write_text(json.dumps({
        "host": "host1", "coverage_ms": 900, "gaps": 1,
        "windows": [{"seq": 1, "t0_ms": 1_759_999_999_000,
                     "t1_ms": 1_759_999_999_400, "pid": 101,
                     "bytes": 10, "gap_before": True}]}))
    (root / j_report.TRIGGER_NAME).write_text(json.dumps({
        "rule": "duty<30", "host": "host1", "metric":
        "tensorcore_duty_cycle_pct", "value": 12.0,
        "ts_ms": 1_760_000_001_000}))
    return laid


@pytest.mark.parametrize("seed", SEEDS)
def test_build_report_equal_apart_from_artifact_names(tmp_path, seed):
    manifests = _manifests(seed)
    roots = {"ref": tmp_path / "ref", "port": tmp_path / "port"}
    _lay_out(roots["ref"], manifests, "streamed.xplane.pb", ".xplane.pb")
    _lay_out(roots["port"], manifests, t_report.STREAMED_ARTIFACT,
             ".pt.trace.json")
    failures = [{"host": "host9:1778", "ok": False,
                 "error": "TimeoutError: x", "attempts": 3,
                 "elapsed_s": 9.0, "t_failed_ms": 1_760_000_002_000},
                {"host": "host0:1778", "ok": True}]
    reports = {}
    for name, mod in (("ref", j_report), ("port", t_report)):
        root = str(roots[name])
        reports[name] = mod.build_report(
            mod.collect_manifests(root), failures=failures,
            trigger=mod.read_trigger(root), retro=mod.collect_retro(root),
            diff_hint="host1")
    arts = {name: reports[name]["metadata"].pop("artifacts")
            for name in reports}
    # Retro and manifest dirs name the side they were read from.
    text = {name: _dumps(reports[name]).replace(str(roots[name]), "ROOT")
            for name in reports}
    assert text["port"] == text["ref"]

    def where(a, root):
        return (a["process"], os.path.relpath(os.path.dirname(a["path"]),
                                              root), a["source"])

    assert ([where(a, roots["port"]) for a in arts["port"]]
            == [where(a, roots["ref"]) for a in arts["ref"]])
    assert [(a["process"], os.path.basename(a["path"]), a["source"])
            for a in arts["port"]] == [
        ("host0_100", "streamed.pt.trace.json", "streamed"),
        ("host1_101", "host1_101.pt.trace.json", "export")]
    md = reports["port"]["metadata"]
    assert md["hosts"] == 3 and md["diff"]["status"] == "ok"
    assert md["streamed_hosts"] == 3 and "capture_start_skew_ms" in md


def test_find_artifact_takes_torch_names_only(tmp_path):
    d = tmp_path / "h_1"
    d.mkdir()
    (d / "old.xplane.pb").write_text("x")
    (d / "streamed.xplane.pb").write_text("x")
    assert t_report.find_artifact(str(d)) is None
    older = d / "a.pt.trace.json"
    newer = d / "sub" / "b.pt.trace.json"
    newer.parent.mkdir()
    older.write_text("{}")
    newer.write_text("{}")
    os.utime(older, (1, 1))
    assert t_report.find_artifact(str(d)) == (str(newer), "export")
    (d / "streamed.pt.trace.json").write_text("{}")
    assert t_report.find_artifact(str(d)) == (
        str(d / "streamed.pt.trace.json"), "streamed")


def _ns(**kw):
    base = dict(log_dir="/tmp/t", duration_ms=500, host_tracer_level=2,
                python_tracer=False, iterations=0, iteration_roundup=10)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("kw,start", [
    ({}, None),
    ({}, 1_760_000_000_123),
    ({"iterations": 5, "python_tracer": True, "host_tracer_level": 3},
     None),
    ({"log_dir": "/d/ü", "duration_ms": 2000}, 1),
])
def test_build_config_byte_identical(kw, start):
    ns = _ns(**kw)
    ref = j_unitrace.build_config(ns, start)
    assert t_unitrace.build_config(ns, start) == ref
    assert json.loads(ref)["type"] == "xplane"


def _journal(seed, host, n):
    rng = np.random.default_rng(seed)
    types = ["collector_started", "watch_fired", "client_registered"]
    out = []
    for k in range(n):
        e = {"seq": k + 1, "ts_ms": 1_760_000_000_000 + int(
            rng.integers(0, 10_000)), "type": types[k % 3],
             "severity": "info", "source": "tpu", "detail": f"{host} {k}"}
        if k % 3 == 1:
            e["metric"] = "hbm_util_pct"
            e["value"] = float(rng.uniform(0, 100))
        out.append(e)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_eventlog_merge_byte_identical(seed):
    events = _journal(seed, "a", 6)
    assert (_dumps(t_eventlog.chrome_instants(events, 4, host="a"))
            == _dumps(j_eventlog.chrome_instants(events, 4, host="a")))
    records = [
        {"host": "a:1", "ok": True, "events": events, "dropped": 2},
        {"host": "b:1", "ok": False, "error": "refused"},
        {"host": "c:1", "ok": False, "error": "died",
         "events": _journal(seed + 10, "c", 3)},
    ]
    base = {"traceEvents": [{"ph": "X", "name": "capture", "pid": 2,
                             "tid": 0, "ts": 1.0, "dur": 2.0}],
            "metadata": {"hosts": 3}}
    out = {}
    for name, mod in (("ref", j_eventlog), ("port", t_eventlog)):
        report = mod.merge_into_report(copy.deepcopy(base),
                                       copy.deepcopy(records))
        # A re-run sweep over the same report adds nothing twice.
        mod.merge_into_report(report, copy.deepcopy(records))
        out[name] = _dumps(report)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("ident", [
    "", "a", "host-0:8080", "tpu-v5e-17.example.internal:1778", "é|x"])
def test_seed_rank_equal(ident):
    assert t_minifleet.seed_rank(ident) == j_minifleet.seed_rank(ident)


@pytest.mark.parametrize("seed", SEEDS)
def test_expected_root_equal(seed):
    rng = np.random.default_rng(seed)
    seeds = [f"host{int(i)}:{int(p)}" for i, p in zip(
        rng.integers(0, 1000, 7), rng.integers(1024, 65536, 7))]
    assert t_minifleet.expected_root(seeds) == \
        j_minifleet.expected_root(seeds)


@pytest.mark.parametrize("n", [2, 4, 16])
def test_ici_ring_args_equal(n):
    for i in range(n):
        assert t_minifleet.ici_ring_args(n, i) == \
            j_minifleet.ici_ring_args(n, i)


@pytest.mark.parametrize("faults", [
    "", "ici_link.degrade_link=1,ici_link.degrade_factor=0.4,"
        "ici_link.link_stalls=5"])
def test_ring_link_series_equal(monkeypatch, faults):
    """Both packages read the ici_link fault scope from the environment;
    the series must agree with and without an edge degraded."""
    monkeypatch.setenv("DYNOLOG_TPU_FAULTS", faults)
    kw = dict(points=5, interval_s=2.0, end_ms=1_760_000_000_000,
              jitter_pct=3.0)
    got = t_minifleet.ring_link_series(4, 2_000_000.0, **kw)
    want = j_minifleet.ring_link_series(4, 2_000_000.0, **kw)
    assert got == want
    if faults:
        assert got[1]["ici_link1_stalls_per_s.dev0"][0][1] == 5


@pytest.mark.parametrize("args", [
    (), ("--storage_dir", "/s/a"), ("--x", "1", "--storage_dir=/s/b"),
    ("--storage_dir",)])
def test_storage_dir_from_args_equal(args):
    assert t_minifleet._storage_dir_from_args(args) == \
        j_minifleet._storage_dir_from_args(args)


def test_read_retro_window_sniffs_content(tmp_path):
    """A window's name says nothing of its content (the daemon names all
    of them win-....xpb): plain JSON and gzipped JSON both decode, and
    anything else is refused."""
    trace = {"traceEvents": [{"ph": "X", "cat": "kernel", "name": "k"}]}
    raw = json.dumps(trace).encode()
    for name, data in (("win-0-1-2-3.xpb", raw),
                       ("win-1-2-3-3.xpb", gzip.compress(raw))):
        (tmp_path / name).write_bytes(data)
        assert t_report.read_retro_window(str(tmp_path / name)) == trace
    (tmp_path / "win-2-3-4-3.xpb").write_bytes(b"retro-fake" * 8)
    with pytest.raises(ValueError):
        t_report.read_retro_window(str(tmp_path / "win-2-3-4-3.xpb"))
