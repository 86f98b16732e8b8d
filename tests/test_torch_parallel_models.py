"""Parity of the port's MoE and pipeline workloads, and of its entry
points, with the JAX package.

The port runs on 8 gloo ranks on the CPU (``run_cpu_mesh``, one thread
each), spawned once for the module's MoE and pipeline cases; the JAX
package runs on its 8 virtual CPU devices. Both take the JAX package's
weights (fp32, and the same values rounded to bf16) and a seed's
tokens. Tolerances:

  mesh shapes        moe_mesh_shape equal to the reference's for
                     n = 1..16 and 4 or 8 experts; the meshes built are
                     (data 2, expert 4) and (pipe 2, data 4), as in
                     tests/test_parallel_models.py
  MoE, (2, 4)        fp32 routes identical; fp32 logits atol 1e-5,
                     loss relative 1e-5; bf16 logits of the tokens
                     routed alike rtol = atol = 2e-2 (the JAX tests'),
                     the bf16 route disagreements counted and at most
                     1 in 64 tokens (0 measured, seed 3); gradients
                     per shard against jax.grad, rtol 1e-4, atol 1e-6
  pipeline, (4, 2)   fp32 logits atol 1e-5, loss relative 1e-5; bf16
                     logits rtol = atol = 2e-2; gradients per shard
                     against jax.grad of pipe_loss, rtol 1e-4, atol 1e-6
  train steps        three bf16 steps, MoE on (2, 4) and the pipeline
                     on (2, 4): finite, and the loss falls
  dryrun             dryrun_multichip(8, device="cpu"): finite losses
  entry              entry(device="cpu") with __graft_entry__.entry()'s
                     weights: bf16 logits max abs <= 0.15
                     (tests/test_torch_model.py's bf16 bound)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

import __graft_entry__ as graft
from dynolog_tpu.models import moe as jmoe
from dynolog_tpu.models import pipeline as jpipe
from dynolog_tpu_torch import entry as tentry
from dynolog_tpu_torch.models import moe as tmoe
from dynolog_tpu_torch.models.transformer import load_jax_params
from dynolog_tpu_torch.parallel import parity
from dynolog_tpu_torch.utils.cpumesh import run_cpu_mesh

STEPS = 3
PIPE_KW = dict(n_stages=4, n_microbatches=2)
PIPE_STEP_KW = dict(n_stages=2, n_microbatches=4)
_JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _moe_inputs():
    cfg = jmoe.MoeConfig.tiny(compute_dtype=jnp.float32)
    params = _np(jmoe.init_moe_params(jax.random.key(2), cfg))
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 16), dtype=np.int32)
    return params, tokens


def _pipe_inputs():
    cfg = jpipe.PipeConfig.tiny(compute_dtype=jnp.float32, **PIPE_KW)
    params = _np(jpipe.init_pipe_params(jax.random.key(4), cfg))
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 16), dtype=np.int32)
    step_tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (16, 32), dtype=np.int32)
    return params, tokens, step_tokens


def _cast(params, dtype, keep=()):
    """The JAX tree in ``dtype`` (bf16 rounds as torch's copy does)."""
    return {k: jnp.asarray(v, jnp.float32 if k in keep else _JDT[dtype])
            for k, v in params.items()}


@pytest.fixture(scope="module")
def world():
    """Every case's results from one 8-rank world, by rank."""
    moe_params, moe_tokens = _moe_inputs()
    pipe_params, pipe_tokens, step_tokens = _pipe_inputs()
    cases = [(parity.moe_case, (moe_params, moe_tokens, STEPS)),
             (parity.pipe_case, (pipe_params, pipe_tokens, PIPE_KW,
                                 PIPE_STEP_KW, step_tokens, STEPS))]
    return run_cpu_mesh(8, parity.run_cases, cases, timeout_s=180)


def test_mesh_shapes_match_reference(world):
    for n in range(1, 17):
        for e in (4, 8):
            assert tmoe.moe_mesh_shape(n, e) == jmoe.moe_mesh_shape(n, e)
    assert {r[0]["mesh"] for r in world} == {(2, 4)}
    assert {r[1]["step_mesh"] for r in world} == {(2, 4)}


def _moe_reference(dtype):
    params, tokens = _moe_inputs()
    cfg = jmoe.MoeConfig.tiny(compute_dtype=_JDT[dtype])
    p = _cast(params, dtype, keep=("gate",))
    x = p["embed"][tokens]
    top = jnp.argmax(jax.nn.softmax(x.astype(jnp.float32) @ p["gate"],
                                    axis=-1), axis=-1)
    logits = jmoe.moe_forward(p, tokens, cfg)
    return (np.asarray(logits), np.asarray(top),
            float(jmoe.moe_loss(p, tokens, cfg)))


def _moe_rows(world, key):
    """Rows of every data rank, from the expert-0 rank of each."""
    got = {r[0]["data_index"]: r[0][key] for r in world
           if r[0]["expert_index"] == 0}
    return np.concatenate([got[i] for i in sorted(got)])


def test_moe_fp32_matches_reference(world):
    logits, top, loss = _moe_reference("fp32")
    np.testing.assert_array_equal(_moe_rows(world, "top_fp32"), top)
    got = _moe_rows(world, "logits_fp32")
    print(f"fp32 MoE logits max abs {np.abs(got - logits).max():.3e}, "
          f"loss port {float(world[0][0]['loss_fp32'])!r} JAX {loss!r}")
    np.testing.assert_allclose(got, logits, rtol=0, atol=1e-5)
    for r in world:
        assert float(r[0]["loss_fp32"]) == pytest.approx(loss, rel=1e-5)


def test_moe_bf16_matches_reference_and_counts_route_flips(world):
    logits, top, loss = _moe_reference("bf16")
    got_top = _moe_rows(world, "top_bf16")
    alike = got_top == top
    flips = int((~alike).sum())
    got = _moe_rows(world, "logits_bf16")
    print(f"bf16 MoE route disagreements: {flips} of {top.size} tokens; "
          f"logits max abs {np.abs(got - logits)[alike].max():.3e}, "
          f"loss port {float(world[0][0]['loss_bf16'])!r} JAX {loss!r}")
    assert flips <= top.size // 64
    np.testing.assert_allclose(got[alike], logits[alike], rtol=2e-2,
                               atol=2e-2)
    if not flips:
        assert float(world[0][0]["loss_bf16"]) == pytest.approx(loss,
                                                                rel=2e-2)


def test_moe_grads_match_reference(world):
    params, tokens = _moe_inputs()
    cfg = jmoe.MoeConfig.tiny(compute_dtype=jnp.float32)
    ref = _np(jax.jit(jax.grad(jmoe.moe_loss), static_argnums=2)(
        params, tokens, cfg))
    for r in world:
        res = r[0]
        e = res["expert_index"]
        for name, dim in tmoe.MOE_PARAM_SPECS.items():
            want = ref[name] if dim is None else ref[name][e:e + 1]
            np.testing.assert_allclose(res["grads"][name], want, rtol=1e-4,
                                       atol=1e-6, err_msg=name)


def _pipe_reference(dtype, grads=False):
    params, tokens, _ = _pipe_inputs()
    cfg = jpipe.PipeConfig.tiny(compute_dtype=_JDT[dtype], **PIPE_KW)
    mesh = jpipe.make_pipe_mesh(jax.devices()[:8], cfg.n_stages)
    with jax.set_mesh(mesh):
        p = jax.device_put(_cast(params, dtype),
                           jpipe.pipe_param_shardings(mesh))
        t = jax.device_put(tokens, NamedSharding(mesh,
                                                 jpipe.PIPE_TOKENS_SPEC))
        if grads:
            return _np(jax.jit(jax.grad(
                lambda p, t: jpipe.pipe_loss(p, t, cfg, mesh)))(p, t))
        fwd = jax.jit(lambda p, t: (jpipe.pipe_forward(p, t, cfg, mesh),
                                    jpipe.pipe_loss(p, t, cfg, mesh)))
        logits, loss = fwd(p, t)
        return np.asarray(logits), float(loss)


@pytest.mark.parametrize("dtype,atol,rtol,rel",
                         [("fp32", 1e-5, 0, 1e-5), ("bf16", 2e-2, 2e-2, 2e-2)])
def test_pipeline_matches_reference(world, dtype, atol, rtol, rel):
    logits, loss = _pipe_reference(dtype)
    worst = max(np.abs(r[1][f"logits_{dtype}"] - logits[r[1]["rows"]]).max()
                for r in world)
    print(f"{dtype} pipeline logits max abs {worst:.3e}, loss port "
          f"{float(world[0][1][f'loss_{dtype}'])!r} JAX {loss!r}")
    for r in world:
        res = r[1]
        np.testing.assert_allclose(res[f"logits_{dtype}"],
                                   logits[res["rows"]], rtol=rtol, atol=atol)
        assert float(res[f"loss_{dtype}"]) == pytest.approx(loss, rel=rel)


def test_pipeline_grads_match_reference(world):
    ref = _pipe_reference("fp32", grads=True)
    for r in world:
        res = r[1]
        s = res["stage"]
        for name, dim in (("embed", None), ("unembed", None), ("w1", 0),
                          ("b1", 0), ("w2", 0), ("ln", 0)):
            want = ref[name] if dim is None else ref[name][s:s + 1]
            np.testing.assert_allclose(res["grads"][name], want, rtol=1e-4,
                                       atol=1e-6, err_msg=f"stage {s} {name}")


@pytest.mark.parametrize("case", [0, 1], ids=["moe", "pipeline"])
def test_train_steps_lower_loss(world, case):
    losses = world[0][case]["steps"]
    assert all(r[case]["steps"] == losses for r in world)
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_dryrun_multichip_on_cpu():
    losses = tentry.dryrun_multichip(8, device="cpu")
    assert set(losses) == {"flagship", "moe", "pipe"}
    assert all(np.isfinite(list(losses.values())))


def test_entry_matches_reference():
    j_fn, j_args = graft.entry()
    ref = np.asarray(jax.jit(j_fn)(*j_args), np.float32)
    fn, (model, tokens) = tentry.entry(device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, j_args[0]))
    out = fn(model, tokens)
    assert out.shape == ref.shape and tokens.device.type == "cpu"
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=0.15)


def test_cuda_dryrun_without_cuda_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        tentry.dryrun_multichip(2)
