"""The port bench's subscription phase against bench.py's own, on the
CPU: the port at the bench's ``--tiny`` sizes (a 1 + 1 + 2 tree),
bench.py's at its smallest arguments (its 1 + 3 + 9 tree is
hard-coded), 8 subscribers and one probe round each.

Outcomes are held equal: every probe event reached every subscriber,
and every subscriber registered. The port's result has the reference's
keys at every level and a number under each REQUIRED key. The port
raises RLIMIT_NOFILE only as far as its sessions need and restores it;
bench.py raises it for good, so the test restores it after.
"""

import resource

import pytest

from dynolog_tpu_torch import bench
from torch_bench_util import TINY, both, held, short_tmp, sock_dir  # noqa


@pytest.fixture
def nofile():
    """RLIMIT_NOFILE as the test found it, restored after."""
    saved = resource.getrlimit(resource.RLIMIT_NOFILE)
    yield saved
    resource.setrlimit(resource.RLIMIT_NOFILE, saved)


def test_subscription(daemon_bin, sock_dir, short_tmp, nofile):
    subs, rounds = TINY["sub_subscribers"], TINY["sub_rounds"]
    ref, port = both(daemon_bin, short_tmp, "measure_subscription",
                     ref_kwargs={"subscribers": subs, "probe_rounds": rounds},
                     subscribers=subs, probe_rounds=rounds,
                     leaves=TINY["sub_leaves"], relays=TINY["sub_relays"])
    held("subscription", ref, port)
    assert port["tree"] == {"depth": 3, "daemons": 4}
    assert ref["tree"] == {"depth": 3, "daemons": 13}
    for r in (ref, port):
        assert r["subscribers"] == r["root_active_sessions"] == subs
        assert r["delivery_ratio"] >= 1.0
        assert r["deliveries"] == r["deliveries_expected"] == \
            r["probe_events"] * subs


def test_nofile_raised_for_the_sessions_and_restored(nofile):
    soft, hard = nofile
    low = 256
    if hard != resource.RLIM_INFINITY and hard < 2 * low + 1024:
        pytest.skip(f"hard RLIMIT_NOFILE {hard} leaves no room to raise")
    resource.setrlimit(resource.RLIMIT_NOFILE, (low, hard))
    with bench._nofile_at_least(2 * low + 1024) as inside:
        assert inside == 2 * low + 1024
        assert resource.getrlimit(resource.RLIMIT_NOFILE)[0] == inside
    assert resource.getrlimit(resource.RLIMIT_NOFILE) == (low, hard)
    with bench._nofile_at_least(64) as inside:  # never lowered
        assert inside == low
    assert resource.getrlimit(resource.RLIMIT_NOFILE) == (low, hard)
