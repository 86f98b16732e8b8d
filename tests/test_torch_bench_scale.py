"""The port bench's fleet-scale phase against bench.py's own, on the
CPU: the port at the bench's ``--tiny`` sizes (a root and 3 interiors,
3 simulated children of 4 hosts, a 1 s byte window), bench.py's at its
smallest arguments (a root and 2 interiors, 2 children of 4 hosts; its
10 s byte window is hard-coded).

Outcomes are held equal: after the first interior's SIGKILL the fleet
reconverged, no simulated host was lost, and the root holds every
simulated host and every live daemon. The port's result has the
reference's keys at every level and a number under each REQUIRED key.
"""

from torch_bench_util import TINY, both, held, short_tmp, sock_dir  # noqa


def test_fleet_scale(daemon_bin, sock_dir, short_tmp):
    kw = {"interiors": TINY["scale_interiors"],
          "sim_children": TINY["scale_children"],
          "hosts_per_child": TINY["scale_hosts_per_child"],
          "sweeps": TINY["scale_sweeps"]}
    assert kw["interiors"] + 1 <= 4
    ref, port = both(daemon_bin, short_tmp, "measure_fleet_scale",
                     ref_kwargs={**kw, "interiors": 2, "sim_children": 2},
                     byte_window_s=TINY["scale_byte_window_s"], **kw)
    held("fleet_scale", ref, port)
    for r in (ref, port):
        assert r["lost_children"] == 0
        assert r["converge_after_kill_s"] is not None
        # The root, the live interiors and every simulated host; the
        # killed interior is stale.
        assert r["records_at_root"] == r["simulated_hosts"] + r["interiors"]
        assert r["fanin"]["actual_bytes"] > 0
    assert (port["simulated_hosts"], port["interiors"]) == (12, 3)
    assert (ref["simulated_hosts"], ref["interiors"]) == (8, 2)
