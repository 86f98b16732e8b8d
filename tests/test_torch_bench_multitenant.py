"""The port bench's multi-tenant phase against bench.py's own, on the
CPU: the port at the bench's ``--tiny`` sizes, bench.py's at its
smallest storm (3 seeds + 1 leaf, one kill trial; its 2 x 200 polite
reads are hard-coded, ~35 s).

Outcomes are held equal: the abusive tenant shed, no orphan of the
authenticated storm lost, no relay verb rejected, the storm's size. The
port's result has the reference's keys at every level and a number
under each REQUIRED key.
"""

from torch_bench_util import TINY, both, held, short_tmp, sock_dir  # noqa


def test_multitenant(daemon_bin, sock_dir, short_tmp):
    storm = {"seeds": TINY["mt_seeds"], "leaves": TINY["mt_leaves"],
             "kill_trials": TINY["mt_kill_trials"]}
    assert storm["seeds"] + storm["leaves"] <= 4
    ref, port = both(daemon_bin, short_tmp, "measure_multitenant",
                     ref_kwargs=storm, polite_reads=TINY["mt_polite_reads"],
                     **storm)
    held("multitenant", ref, port)
    for r in (ref, port):
        assert r["abuser"]["shed"] > 0
        assert r["tenant_counts"]["polite"]["shed"] == 0
        assert (r["storm_lost_children"], r["storm_auth_rejected_total"]) \
            == (0, 0)
        assert (r["storm_reparent_s"] is None) == \
            (r["storm_reparented_children"] == 0)
    assert (port["storm_hosts"], port["storm_kill_trials"]) == \
        (ref["storm_hosts"], ref["storm_kill_trials"]) == \
        (storm["seeds"] + storm["leaves"], storm["kill_trials"])
