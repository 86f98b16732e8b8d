#!/usr/bin/env python3
"""bench.py's own fleet phases beside the PyTorch port's, on one host.

    python3 scripts/fleet_same_host.py [--tiny] [--out FILE]

Runs `measure_fleet_selfheal` (256 self-forming daemons: re-parent after
seed kills, root promotion, the sweep after it) and
`measure_fleet_scale` (1,024 simulated hosts over 8 interiors: root sweep,
fan-in bytes, reconvergence after an interior's kill) from the repo's
`bench.py` and from `dynolog_tpu_torch.bench`, alternated reference,
port, reference, port, in one process, on one daemon binary built once
by `dynolog_tpu_torch.bench.build_native`, under one RLIMIT_NOFILE. Both
sides run at their defaults, which are bench.py's sizes (`--tiny`: the
port bench's TINY_FLEET sizes, for a rehearsal on a small host).

JAX is refused at import: bench.py's daemon-only phases need none, so
this runs on a host without it. Prints the card line (nvidia-smi's name
and power limit), the CPU count and the descriptor limit, one line per
run, and last one JSON object of every run's outcome (also written to
``--out``). A phase that raises is recorded with its error and the
alternation goes on.
"""

from __future__ import annotations

import argparse
import importlib.abc
import json
import os
import pathlib
import resource
import subprocess
import sys
import tempfile
import time
import traceback

REPO = pathlib.Path(__file__).resolve().parent.parent
REFUSED = ("jax", "jaxlib")
ROUNDS = 2  # reference/port pairs per phase


class _RefuseJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"{name} is refused on this run")
        return None


def _p(d, *keys):
    for k in keys:
        if not isinstance(d, dict):
            return None
        d = d.get(k)
    return d


def selfheal_line(r):
    return (f"re-parent p95 {_p(r, 'reparent_s', 'p95')} s, "
            f"re-parented {r.get('reparented_children')} / lost "
            f"{r.get('lost_children')}, root promotion "
            f"{r.get('root_promotion_s')} s, post_promotion_full_sweep_s "
            f"{r.get('post_promotion_full_sweep_s')}")


def scale_line(r):
    return (f"sweep p50 {_p(r, 'sweep_ms', 'median')} / p95 "
            f"{_p(r, 'sweep_ms', 'p95')} ms, fan-in "
            f"{_p(r, 'fanin', 'reduction_x')}x, converge_after_kill_s "
            f"{r.get('converge_after_kill_s')}, lost hosts "
            f"{r.get('lost_children')}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true",
                    help="the port bench's TINY_FLEET sizes on both sides")
    ap.add_argument("--out", type=pathlib.Path,
                    help="also write the final JSON object here")
    args = ap.parse_args(argv)

    sys.meta_path.insert(0, _RefuseJax())
    sys.path.insert(0, str(REPO))
    import bench as ref_bench
    from dynolog_tpu_torch import bench as port_bench

    try:
        card = port_bench.card_line()
    except (OSError, subprocess.CalledProcessError) as e:
        card = f"no card line ({e})"
    host = {"card": card, "cpu_count": os.cpu_count(),
            "nofile": list(resource.getrlimit(resource.RLIMIT_NOFILE))}
    print(f"card: {host['card']}", flush=True)
    print(f"host: cpu_count {host['cpu_count']}, ulimit -n "
          f"{host['nofile'][0]} (hard {host['nofile'][1]})", flush=True)

    daemon_bin, _, build_s = port_bench.build_native()
    print(f"build: {daemon_bin.relative_to(REPO)} in {build_s:.1f} s",
          flush=True)
    tmp = tempfile.mkdtemp(prefix="dtpu_same_host_")
    os.environ["DYNOLOG_TPU_SOCKET_DIR"] = tmp

    kw = {"measure_fleet_selfheal": {}, "measure_fleet_scale": {}}
    if args.tiny:
        t = port_bench.TINY_FLEET
        kw["measure_fleet_selfheal"] = {
            "seeds": t["heal_seeds"], "leaves": t["heal_leaves"],
            "kill_trials": t["heal_kill_trials"],
            "sweep_trials": t["heal_sweep_trials"],
            "trigger_trials": t["heal_trigger_trials"]}
        kw["measure_fleet_scale"] = {
            "interiors": t["scale_interiors"],
            "sim_children": t["scale_children"],
            "hosts_per_child": t["scale_hosts_per_child"],
            "sweeps": t["scale_sweeps"]}
    lines = {"measure_fleet_selfheal": selfheal_line,
             "measure_fleet_scale": scale_line}
    sides = (("ref", ref_bench), ("port", port_bench))
    runs = []
    for phase, line in lines.items():
        for i in range(ROUNDS):
            for side, mod in sides:
                sub = tempfile.mkdtemp(prefix=f"{side}{i}", dir=tmp)
                t0 = time.monotonic()
                try:
                    result, error = getattr(mod, phase)(
                        daemon_bin, sub, **kw[phase]), None
                except Exception as e:  # recorded; the alternation goes on
                    traceback.print_exc()
                    result, error = {}, f"{type(e).__name__}: {e}"
                wall_s = round(time.monotonic() - t0, 3)
                runs.append({"phase": phase, "round": i, "side": side,
                             "wall_s": wall_s, "error": error,
                             "result": result})
                print(f"{phase} [{host['card']}] round {i} {side}: "
                      f"{line(result)}, wall {wall_s} s"
                      + (f", error {error}" if error else ""), flush=True)
    record = {"host": host, "tiny": args.tiny, "runs": runs}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
