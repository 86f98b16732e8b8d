"""The port bench's fleet and recovery phases against bench.py's own, on
the CPU, at the bench's ``--tiny`` sizes.

Each test runs one phase of ``bench.py`` (the JAX package's minifleet,
fleetstatus, eventlog and client) and its port in
``dynolog_tpu_torch.bench`` (the port's), one after the other, and
holds the port to the reference:

  * every value that is an outcome is equal (exact): the hosts and
    whether the capture windows intersect, the shims' restart counters,
    the flagged straggler, the host each tree path flags, the promoted
    root, the journal's counts, one artifact per auto-capture firing;
  * the port's result has the reference's keys at every level, with a
    number under each timing key (``bench.missing_numbers``).

The runs use the session's built binaries (no build here), a short
socket dir from tempfile (pytest's per-test dirs overflow AF_UNIX
paths), at most 4 daemons a phase (a restart adds one), and a deadline
on every phase.
"""

import glob
import os

import bench as ref_bench
from dynolog_tpu.fleet import fleetstatus as ref_fleetstatus
from dynolog_tpu.fleet import minifleet as ref_minifleet
from dynolog_tpu_torch import bench
from dynolog_tpu_torch.fleet import fleetstatus, minifleet
from torch_bench_util import TINY, sock_dir  # noqa: F401 (a fixture)
from torch_bench_util import bounded as _bounded
from torch_bench_util import held as _held
from torch_bench_util import spy as _spy


def _both(daemon_bin, tmp_path, name, **kwargs):
    """(bench.py's result, the port's) of phase ``name`` at ``kwargs``,
    each with a tmp dir of its own."""
    got = []
    for side, mod in (("ref", ref_bench), ("port", bench)):
        tmp = tmp_path / side
        tmp.mkdir()
        got.append(_bounded(getattr(mod, name), daemon_bin, str(tmp),
                            **kwargs))
    return got


def test_fleet_fanout(daemon_bin, tmp_path, sock_dir):
    n = TINY["fleet_hosts"][0]
    assert n <= 4
    ref, port = _both(daemon_bin, tmp_path, "measure_fleet_fanout",
                      n_hosts=n)
    _held("fleet", {str(n): ref}, {str(n): port})
    assert (port["hosts"], port["windows_intersect"]) == (
        ref["hosts"], ref["windows_intersect"]) == (n, True)


def test_restart_recovery(daemon_bin, tmp_path, sock_dir):
    kw = {"n_hosts": TINY["restart_hosts"],
          "trials": TINY["restart_trials"]}
    ref, port = _both(daemon_bin, tmp_path, "measure_restart_recovery", **kw)
    _held("restart_recovery", ref, port)
    keys = ("daemon_restarts_detected", "reregistrations")
    assert [port["client_counters"][k] for k in keys] == \
        [ref["client_counters"][k] for k in keys] == [kw["trials"]] * 2
    assert (port["hosts"], port["trials"]) == (ref["hosts"], ref["trials"])


def _outliers_by_index(spawned, result):
    """{(host index, metric)} of a fleet_health result, by the order the
    phase spawned its daemons."""
    (_, _, daemons), = spawned
    index = {f"localhost:{p}": i for i, (_, p) in enumerate(daemons)}
    return {(index[o["host"]], o["metric"]) for o in result["outliers"]}


def test_fleet_health(daemon_bin, tmp_path, sock_dir, monkeypatch):
    ref_spawned = _spy(monkeypatch, ref_minifleet, "spawn_daemons")
    spawned = _spy(monkeypatch, minifleet, "spawn_daemons")
    ref, port = _both(daemon_bin, tmp_path, "measure_fleetstatus",
                      n_hosts=TINY["fstat_hosts"])
    _held("fleet_health", ref, port)
    assert port["straggler_detected"] == ref["straggler_detected"] is True
    want = _outliers_by_index(ref_spawned, ref)
    assert _outliers_by_index(spawned, port) == want
    assert {i for i, _ in want} == {2}


def _flagged_by_index(spawned, sweeps):
    """The daemon indices the last verdict of ``sweeps`` flags."""
    (_, _, daemons), = spawned
    index = {str(p): i for i, (_, p) in enumerate(daemons)}
    verdict = sweeps[-1][2]
    return {index[o["host"].rsplit(":", 1)[1]] for o in verdict["outliers"]}


def test_fleet_tree(daemon_bin, tmp_path, sock_dir, monkeypatch):
    kw = {"n_hosts": TINY["tree_hosts"], "relays": TINY["tree_relays"],
          "trials": TINY["tree_trials"]}
    assert kw["n_hosts"] <= 4
    spies = {}
    for side, mf, fs in (("ref", ref_minifleet, ref_fleetstatus),
                         ("port", minifleet, fleetstatus)):
        spies[side] = (_spy(monkeypatch, mf, "spawn_tree"),
                       _spy(monkeypatch, fs, "tree_sweep"),
                       _spy(monkeypatch, fs, "sweep"))
    ref, port = _both(daemon_bin, tmp_path, "measure_fleet_tree", **kw)
    _held("fleet_tree", ref, port)
    flagged = {side: tuple(_flagged_by_index(spawn, sw)
                           for sw in (tree, flat))
               for side, (spawn, tree, flat) in spies.items()}
    straggler = kw["n_hosts"] - 1
    assert flagged["port"] == flagged["ref"] == ({straggler}, {straggler})
    assert port["straggler_parity"] == ref["straggler_parity"] is True


def _promoted_root(spawned, killed, sweeps):
    """Whether the root the last tree sweep reports is expected_root of
    the seeds left alive, and the hosts the phase spawned."""
    (args, kwargs, (daemons, seed_list)), = spawned
    dead = {daemons[a[1]][1] for a, _, _ in killed}
    live = [s for s in seed_list if int(s.rsplit(":", 1)[1]) not in dead]
    root = next(v for _, _, v in reversed(sweeps) if v is not None)["root"]
    return (root.rsplit(":", 1)[1]
            == minifleet.expected_root(live).rsplit(":", 1)[1],
            len(daemons), len(dead))


def test_fleet_selfheal(daemon_bin, tmp_path, sock_dir, monkeypatch):
    kw = {"seeds": TINY["heal_seeds"], "leaves": TINY["heal_leaves"],
          "kill_trials": TINY["heal_kill_trials"],
          "sweep_trials": TINY["heal_sweep_trials"],
          "trigger_trials": TINY["heal_trigger_trials"]}
    assert kw["seeds"] + kw["leaves"] <= 4
    spies = {}
    for side, mf, fs in (("ref", ref_minifleet, ref_fleetstatus),
                         ("port", minifleet, fleetstatus)):
        spies[side] = (_spy(monkeypatch, mf, "spawn_seeded"),
                       _spy(monkeypatch, mf, "kill_daemon"),
                       _spy(monkeypatch, fs, "tree_sweep"))
    ref, port = _both(daemon_bin, tmp_path, "measure_fleet_selfheal", **kw)
    _held("fleet_selfheal", ref, port)
    promoted = {side: _promoted_root(*s) for side, s in spies.items()}
    # The seeds' ports are drawn at random, so whether a seed other than
    # the root had the leaf (and so how many were killed) may differ.
    assert promoted["port"][:2] == promoted["ref"][:2] == (True, 4)
    for r in (ref, port):
        assert r["root_promotion_s"] is not None
        assert (r["reparent_s"] is None) == (r["reparented_children"] == 0)
    assert (port["hosts"], port["seeds"]) == (ref["hosts"], ref["seeds"])


def test_event_journal(daemon_bin, tmp_path, sock_dir):
    ref, port = _both(daemon_bin, tmp_path, "measure_event_journal",
                      capacity=bench.FULL.journal_capacity)
    _held("event_journal", ref, port)
    keys = ("ring_capacity", "staged_events", "events_drained",
            "evicted_total")
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}


def test_degraded_mode(daemon_bin, tmp_path, sock_dir):
    ref, port = _both(daemon_bin, tmp_path, "measure_degraded_mode",
                      window_s=TINY["degraded_window_s"])
    _held("degraded_mode", ref, port)
    assert port["degraded"]["tpu_state"] == ref["degraded"]["tpu_state"] \
        == "quarantined"


def test_autocapture(daemon_bin, tmp_path, sock_dir, monkeypatch):
    rules = TINY["autocapture_rules"]
    spawned = {"ref": _spy(monkeypatch, ref_minifleet, "spawn"),
               "port": _spy(monkeypatch, minifleet, "spawn")}
    ref, port = _both(daemon_bin, tmp_path, "measure_autocapture",
                      rules=rules)
    _held("autocapture", ref, port)
    assert (port["firings"], port["hosts"]) == (ref["firings"],
                                                ref["hosts"]) == (rules, 3)
    for side, pattern in (("ref", "*.xplane.pb"), ("port", "*.pt.trace.json")):
        clients = [c for _, _, (_, cs) in spawned[side] for c in cs]
        assert [c.captures_completed for c in clients] == [rules] * 3, side
        artifacts = glob.glob(os.path.join(
            tmp_path, side, "autocap_bench", "**", pattern), recursive=True)
        assert len(artifacts) == 3, (side, artifacts)
