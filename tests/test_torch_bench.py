"""The port's bench (``python -m dynolog_tpu_torch.bench``) against the
reference's ``bench.py``, on the CPU.

  * ``_p95`` and ``_stats`` equal bench.py's on seeded lists of 1-60
    samples (exact);
  * the flagship configuration is bench.py:make_step's, field for field;
  * the bench's step, from the JAX package's weights, follows the JAX
    train step over 3 steps in float32 (losses within 1e-5);
  * a capture's trace_timing stamps turn into the latency breakdown;
  * ``--device cuda`` without a card exits non-zero and names CUDA;
  * one ``--device cpu --quick --tiny`` run prints one JSON line with a
    number under every key the bench requires, the fleet, recovery and
    daemon-side phases among them at ``--tiny``'s sizes, each with the
    outcome bench.py's assertions gate on.

The runs use the session's built binaries (no build here), a short
socket dir from tempfile, one torch thread, a deadline on every wait,
and nice 19, so that they take as little as they can from the tests
that run beside them; ``--tiny`` runs one burner of at most 0.5 s.
"""

import ast
import json
import os
import pathlib
import random
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as ref_bench
from dynolog_tpu.models import train as jtrain
from dynolog_tpu.models import transformer as jtf
from dynolog_tpu_torch import bench
from dynolog_tpu_torch.models import transformer as ttf

REPO = pathlib.Path(__file__).resolve().parent.parent
RUN_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_p95_and_stats_equal_the_reference():
    rng = random.Random(7)
    for n in range(1, 61):
        xs = [rng.uniform(0.1, 900.0) for _ in range(n)]
        assert bench._p95(xs) == ref_bench._p95(xs), n
        assert bench._stats(xs) == ref_bench._stats(xs), n


def _make_step_calls():
    """bench.py:make_step's ModelConfig keywords and its token shape."""
    tree = ast.parse((REPO / "bench.py").read_text(encoding="utf-8"))
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "make_step")
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
    cfg = next(c for c in calls if getattr(c.func, "id", "") == "ModelConfig")
    randint = next(c for c in calls
                   if getattr(c.func, "attr", "") == "randint")
    return ({k.arg: ast.literal_eval(k.value) for k in cfg.keywords},
            ast.literal_eval(randint.args[1]))


def test_default_config_is_bench_py_make_step():
    fields, shape = _make_step_calls()
    assert fields == {"vocab_size": 8192, "d_model": 512, "n_layers": 8,
                      "n_heads": 8, "d_ff": 1408, "max_seq_len": 512}
    for name, value in fields.items():
        assert getattr(bench.FLAGSHIP, name) == value, name
    assert (bench.BATCH, bench.SEQ) == shape
    # The fields bench.py leaves at their defaults: bf16 compute, remat.
    ref = jtf.ModelConfig(**fields)
    assert ref.compute_dtype == jnp.bfloat16 and ref.remat
    assert bench.FLAGSHIP.compute_dtype == torch.bfloat16
    assert bench.FLAGSHIP.remat and bench.FLAGSHIP.rope_theta == ref.rope_theta
    assert bench.FLAGSHIP.seq_axis is None and ref.seq_axis is None


def test_step_from_jax_weights_follows_the_jax_step():
    jcfg = jtf.ModelConfig.tiny(compute_dtype=jnp.float32)
    tcfg = ttf.ModelConfig.tiny(compute_dtype=torch.float32)
    assert (tcfg.n_layers, tcfg.d_model) == (2, 64)
    params = jax.tree.map(np.asarray, jtf.init_params(jax.random.key(0), jcfg))
    step_fn, make_batch = bench.make_step(tcfg, "cpu", batch=2, seq=16,
                                          params=params)
    tokens = make_batch(0).numpy().astype(np.int32)
    opt = jtrain.make_optimizer()
    jstep = jax.jit(jtrain.make_train_step(jcfg, opt))
    jparams, jopt = params, opt.init(params)
    got, want = [], []
    for i in range(3):
        got.append(float(step_fn(make_batch(i))))
        jparams, jopt, loss = jstep(jparams, jopt, tokens)
        want.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got[-1] < got[0]


def test_trace_breakdown_of_fixed_stamps():
    t = {"config_received": 100.002, "delivery": "push",
         "trace_start": 100.010, "start_returned": 100.011,
         "stop_begin": 100.320, "trace_stop": 100.620,
         "export_done": 100.900, "stream_commit": 101.000}
    got = bench.trace_breakdown(100.0, t, t_artifact=100.950)
    want = {"rpc_to_config": 2.0, "config_to_start": 8.0, "start_call": 1.0,
            "start_to_stop": 610.0, "stop_call": 300.0,
            "stop_to_artifact": 280.0, "stop_to_stream_commit": 380.0,
            "e2e": 950.0, "nonwindow": 650.0}
    assert got == pytest.approx(want, abs=1e-6)
    del t["stream_commit"]
    got = bench.trace_breakdown(100.0, t)
    assert set(got) == set(bench.BREAKDOWN) - {"stop_to_stream_commit"}


def _run(args, timeout_s):
    """The bench in a session of its own, niced, one torch thread and no
    card visible; returns (rc, stdout, stderr). Past the deadline the
    whole session (daemons and burners too) is killed."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen(
        ["nice", "-n", "19", sys.executable, "-m", "dynolog_tpu_torch.bench",
         *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    return proc.returncode, out, err


def test_cuda_without_a_card_exits_nonzero_and_names_cuda():
    rc, out, err = _run(["--device", "cuda"], 60)
    assert rc != 0
    assert "CUDA" in err
    assert "telemetry_overhead_pct" not in out


def test_quick_tiny_run_prints_a_number_for_every_key(native_build):
    rc, out, err = _run(
        ["--device", "cpu", "--quick", "--tiny",
         "--daemon-bin", str(native_build / "dynolog_tpu_daemon"),
         "--dyno-bin", str(native_build / "dyno")], RUN_TIMEOUT_S)
    assert rc == 0, err[-4000:]
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out
    record = json.loads(lines[0])
    assert record["metric"] == "telemetry_overhead_pct"
    assert record["unit"] == "%"
    d = record["detail"]
    assert set(bench.REQUIRED) <= set(d)
    assert bench.missing_numbers(d) == []
    assert record["value"] == d["overhead"]["overhead_pct"]
    assert d["platform"] == "cpu" and d["card"] is None
    assert "vs_baseline" not in record and "assertions" not in d
    assert (d["model"]["n_layers"], d["model"]["d_model"]) == (2, 64)
    lh = d["loaded_host"]
    assert lh["cpus_saturated"] == 1
    assert lh["target_s"] <= 0.5  # the quantum a burner is calibrated to
    assert d["trace_latency"]["push"] and d["trace_latency"]["stream"]
    fallback = d["trace_latency_poll_fallback"]
    assert not fallback["push"] and not fallback["stream"]
    assert fallback["deliveries"] == ["poll"]
    assert "stop_to_stream_commit" not in fallback["phases_ms"]
    # bench.py's fleet and recovery phases, at --tiny's <= 4 daemons and
    # a single trial, each with its outcome.
    assert {"fleet", "restart_recovery", "fleet_health", "fleet_tree",
            "fleet_selfheal", "event_journal", "degraded_mode",
            "autocapture"} <= set(bench.REQUIRED)
    assert list(d["fleet"]) == ["4"] and d["fleet"]["4"]["windows_intersect"]
    assert (d["restart_recovery"]["hosts"],
            d["restart_recovery"]["trials"]) == (2, 1)
    assert d["fleet_health"]["straggler_detected"]
    assert (d["fleet_tree"]["hosts"], d["fleet_tree"]["trials"]) == (4, 1)
    assert d["fleet_tree"]["straggler_parity"]
    heal = d["fleet_selfheal"]
    assert (heal["hosts"], heal["kill_trials"]) == (4, 1)
    assert d["degraded_mode"]["degraded"]["tpu_state"] == "quarantined"
    assert (d["autocapture"]["firings"], d["autocapture"]["hosts"]) == (1, 3)
    assert [k for k in d["phase_s"] if k.startswith("fleet_")] == [
        "fleet_4", "fleet_health", "fleet_tree", "fleet_selfheal",
        "fleet_scale"]
    # bench.py's last seven phases, in its order, at --tiny's sizes.
    new = ["durability", "sketch_quantiles", "read_swarm", "multitenant",
           "link_localization", "subscription", "fleet_scale"]
    assert set(new) <= set(bench.REQUIRED)
    assert list(d["phase_s"])[-len(new):] == new
    assert d["durability"]["recovered"]["frames"] > 0
    assert d["durability"]["store_at_kill"]["evictions_total"] > 0
    assert d["sketch_quantiles"]["samples_per_workload"] == 20_000
    assert d["read_swarm"]["errors"] == 0
    mt = d["multitenant"]
    assert (mt["storm_hosts"], mt["storm_lost_children"],
            mt["storm_auth_rejected_total"]) == (4, 0, 0)
    assert mt["abuser"]["shed"] > 0
    link = d["link_localization"]
    assert link["hosts"] == 4 and link["exact_edge"]
    assert link["false_positive_hosts"] == 0
    sub = d["subscription"]
    assert sub["tree"]["daemons"] == 4 and sub["delivery_ratio"] >= 1.0
    scale = d["fleet_scale"]
    assert (scale["interiors"], scale["lost_children"]) == (3, 0)
    assert scale["converge_after_kill_s"] is not None
    # Other tests' daemons share the host: only the keys are fixed.
    state = d["host_state"]
    assert list(state) == ["start", *bench.DAEMON_PHASES]
    assert all(set(s) == {"open_fds", "threads", "nofile_soft",
                          "live_daemons"} for s in state.values())
