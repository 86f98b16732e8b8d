"""The port bench's durability, read-swarm and link-localization phases
against bench.py's own, on the CPU, at the bench's ``--tiny`` sizes
(bench.py's own at its smallest arguments where it hard-codes a wall
time: the read swarm's 6 s, the link sweeps' 3 s).

Outcomes are held equal: a store filled past its budget and recovered
with frames; every read of the swarm answered; on a 4-host ring with
edge 1 degraded, the one edge flagged (by host index), its deficit and
no host blamed. The port's result has the reference's keys at every
level and a number under each REQUIRED key.
"""

import bench as ref_bench
from dynolog_tpu.fleet import minifleet as ref_minifleet
from dynolog_tpu_torch import bench
from dynolog_tpu_torch.fleet import minifleet
from torch_bench_util import TINY, both, held, short_tmp, sock_dir  # noqa
from torch_bench_util import spy


def test_durability(daemon_bin, sock_dir, short_tmp):
    ref, port = both(daemon_bin, short_tmp, "measure_durability",
                     window_s=TINY["durability_window_s"])
    held("durability", ref, port)
    for r in (ref, port):
        assert r["store_at_kill"]["evictions_total"] > 0
        assert r["recovered"]["frames"] > 0


def test_read_swarm(daemon_bin, sock_dir, short_tmp):
    readers, waves = TINY["swarm_readers"], TINY["swarm_waves"]
    ref, port = both(daemon_bin, short_tmp, "measure_read_swarm",
                     ref_kwargs={"readers": readers, "waves": waves},
                     readers=readers, waves=waves,
                     min_wall_s=TINY["swarm_min_wall_s"])
    held("read_swarm", ref, port)
    assert port["errors"] == ref["errors"] == 0
    assert port["readers"] == ref["readers"] == readers
    assert port["requests"] == readers * port["waves"]


def _flagged_by_index(spawned, n_hosts, result):
    """The (host index, host index) of each LINK_BOUND edge of a result,
    by the order the topologized fleet (the second) was spawned."""
    ring = [value[0][1] for _, _, value in spawned[n_hosts:]]
    index = {f"localhost:{p}": i for i, p in enumerate(ring)}
    return [tuple(index[h] for h in b["hosts"])
            for b in result["link_bound"]]


def test_link_localization(daemon_bin, sock_dir, short_tmp, monkeypatch):
    kw = {"n_hosts": TINY["link_hosts"], "degraded_edge": TINY["link_edge"],
          "trials": TINY["link_trials"]}
    assert kw["n_hosts"] <= 4 and kw["degraded_edge"] < kw["n_hosts"]
    spawned = {"ref": spy(monkeypatch, ref_minifleet, "spawn_daemons"),
               "port": spy(monkeypatch, minifleet, "spawn_daemons")}
    ref, port = both(daemon_bin, short_tmp, "measure_link_localization",
                     ref_kwargs=kw, min_wall_s=TINY["link_min_wall_s"], **kw)
    held("link_localization", ref, port)
    edge = kw["degraded_edge"]
    assert _flagged_by_index(spawned["port"], kw["n_hosts"], port) == \
        _flagged_by_index(spawned["ref"], kw["n_hosts"], ref) == \
        [(edge, edge + 1)]
    assert port["deficit_pct"] == ref["deficit_pct"]
    for r in (ref, port):
        assert r["exact_edge"] and r["false_positive_hosts"] == 0
        assert r["link_scoring"]["status"] == "ok"
    assert port["host_only_link_scoring"] == ref["host_only_link_scoring"]
