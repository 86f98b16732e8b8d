"""Parity of the port's parallel flagship path with the JAX package.

The port runs on 8 gloo ranks on the CPU (``run_cpu_mesh``, one thread
each), spawned once for the module; the JAX package runs on its 8
virtual CPU devices. Both take the same numpy inputs from a seed, and
the JAX package's ``init_params`` weights (``load_jax_params`` cuts each
rank's shards by PARAM_SPECS). Tolerances:

  mesh_shape          equal to the reference's for n = 1..16
  ring attention      fp32 on 2, 4 and 8 ranks, rtol = atol = 2e-5
                      (tests/test_ring_attention.py's) against JAX
                      ring_attention on the virtual mesh and against
                      dense_causal_attention; row 0 finite
  ring gradients      of sum(out * cot) against the dense attention's
                      torch gradients, rtol = atol = 2e-5
  flagship loss       (data, seq, model) = (2, 2, 2), ring attention on:
                      fp32 relative 1e-5, bf16 relative 5e-3 (as
                      tests/test_model.py's sharded-loss check), against
                      JAX's loss_fn on its sharded mesh
  flagship gradients  each rank's shards after the data/seq sum against
                      jax.grad of the unsharded fp32 loss, rtol 1e-4,
                      atol 1e-6 (tests/test_torch_model.py's)
  five fp32 steps     each loss within relative 1e-5 of JAX's
                      make_sharded_train_step on the same mesh (1.6e-7
                      measured), and the loss falls
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dynolog_tpu.models import train as jtrain
from dynolog_tpu.models import transformer as jtf
from dynolog_tpu.parallel import mesh as jmesh
from dynolog_tpu.parallel.ring_attention import (
    dense_causal_attention as j_dense,
    ring_attention as j_ring,
)
from dynolog_tpu_torch.models.transformer import shard_jax_params
from dynolog_tpu_torch.parallel import mesh as tmesh
from dynolog_tpu_torch.parallel import parity
from dynolog_tpu_torch.utils.cpumesh import run_cpu_mesh

RING_SIZES = (2, 4, 8)
SHAPE = (2, 2, 2)
STEPS = 5


def _ring_inputs():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
                 for _ in range(4))


def _flagship_inputs():
    cfg = jtf.ModelConfig.tiny(compute_dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jtf.init_params(jax.random.key(0), cfg))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 64), dtype=np.int32)
    return params, tokens


@pytest.fixture(scope="module")
def world():
    """Every case's results from one 8-rank world, by rank."""
    q, k, v, cot = _ring_inputs()
    params, tokens = _flagship_inputs()
    cases = [(parity.ring_case, (q, k, v, cot, RING_SIZES)),
             (parity.flagship_case, ({}, params, tokens, SHAPE, STEPS))]
    return run_cpu_mesh(8, parity.run_cases, cases, timeout_s=180)


def test_mesh_shape_matches_reference():
    for n in range(1, 17):
        assert tmesh.mesh_shape(n) == jmesh.mesh_shape(n), n


def _ring_out(world, n, key):
    return np.concatenate([world[r][0][n][key] for r in range(n)], axis=1)


@pytest.mark.parametrize("n", RING_SIZES)
def test_ring_matches_reference_and_dense(world, n):
    q, k, v, _ = _ring_inputs()
    out = _ring_out(world, n, "out")
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
    spec = NamedSharding(mesh, P(None, "seq", None, None))
    with jax.set_mesh(mesh):
        ref = jax.jit(j_ring)(*(jax.device_put(a, spec) for a in (q, k, v)))
    dense = np.asarray(j_dense(q, k, v))
    print(f"ring {n}: max abs vs JAX ring "
          f"{np.abs(out - np.asarray(ref)).max():.3e}, vs dense "
          f"{np.abs(out - dense).max():.3e}")
    np.testing.assert_allclose(out, np.asarray(ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, dense, rtol=2e-5, atol=2e-5)
    assert np.isfinite(out[:, 0]).all()


@pytest.mark.parametrize("n", RING_SIZES)
def test_ring_grads_match_dense(world, n):
    q, k, v, cot = _ring_inputs()
    ref = jax.grad(lambda q, k, v: jnp.sum(j_dense(q, k, v) * cot),
                   argnums=(0, 1, 2))(q, k, v)
    for key, want in zip(("dq", "dk", "dv"), ref):
        np.testing.assert_allclose(_ring_out(world, n, key), np.asarray(want),
                                   rtol=2e-5, atol=2e-5, err_msg=key)


def _jax_sharded_loss(params, tokens, dtype):
    cfg = jtf.ModelConfig.tiny(compute_dtype=dtype, seq_axis="seq")
    mesh = jmesh.make_mesh(jax.devices()[:8], SHAPE)
    with jax.set_mesh(mesh):
        p = jax.device_put(params, jmesh.param_shardings(mesh))
        t = jax.device_put(tokens, NamedSharding(mesh, jmesh.TOKENS_SPEC))
        return float(jax.jit(lambda p, t: jtrain.loss_fn(p, t, cfg))(p, t))


@pytest.mark.parametrize("dtype,rel", [("fp32", 1e-5), ("bf16", 5e-3)])
def test_sharded_loss_matches_reference(world, dtype, rel):
    params, tokens = _flagship_inputs()
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    ref = _jax_sharded_loss(params, tokens, jdt)
    losses = [float(world[r][1][f"loss_{dtype}"]) for r in range(8)]
    assert max(losses) == min(losses)  # every rank holds the same mean
    print(f"{dtype} sharded loss: port {losses[0]!r} JAX {ref!r} "
          f"rel {abs(losses[0] - ref) / ref:.3e}")
    assert losses[0] == pytest.approx(ref, rel=rel)


def test_sharded_grads_match_reference(world):
    params, tokens = _flagship_inputs()
    cfg = jtf.ModelConfig.tiny(compute_dtype=jnp.float32)
    ref = jax.tree.map(np.asarray, jax.jit(
        jax.grad(jtrain.loss_fn), static_argnums=2)(params, tokens, cfg))
    for r in range(8):
        res = world[r][1]
        want = shard_jax_params(ref, res["model_index"], SHAPE[2])
        grads = res["grads"]
        for name in ("embed", "unembed", "final_norm"):
            np.testing.assert_allclose(grads[name], want[name], rtol=1e-4,
                                       atol=1e-6, err_msg=f"rank {r} {name}")
        for key, stack in want["layers"].items():
            for i in range(cfg.n_layers):
                np.testing.assert_allclose(
                    grads[f"layers.{i}.{key}"], stack[i], rtol=1e-4,
                    atol=1e-6, err_msg=f"rank {r} layers.{i}.{key}")


def test_sharded_steps_track_reference(world):
    params, tokens = _flagship_inputs()
    cfg = jtf.ModelConfig.tiny(compute_dtype=jnp.float32, seq_axis="seq")
    mesh = jmesh.make_mesh(jax.devices()[:8], SHAPE)
    with jax.set_mesh(mesh):
        p = jax.device_put(params, jmesh.param_shardings(mesh))
        opt_state = jax.jit(jtrain.make_optimizer().init)(p)
        step = jtrain.make_sharded_train_step(cfg, mesh)
        t = jax.device_put(tokens, NamedSharding(mesh, jmesh.TOKENS_SPEC))
        ref = []
        for _ in range(STEPS):
            p, opt_state, loss = step(p, opt_state, t)
            ref.append(float(loss))
    got = world[0][1]["steps"]
    assert all(world[r][1]["steps"] == got for r in range(8))
    print(f"steps: port {got} JAX {ref} max rel "
          f"{max(abs(a - b) / b for a, b in zip(got, ref)):.3e}")
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert got[-1] < got[0]
