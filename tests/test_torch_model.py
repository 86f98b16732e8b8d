"""Parity of the port's flagship workload with the JAX package.

The same weights (the JAX package's init_params, carried over with
load_jax_params) and the same tokens (numpy, from a seed) go through
dynolog_tpu.models and dynolog_tpu_torch.models on the CPU. Tolerances:

  fp32 logits     max abs <= 1e-4 (two float32 implementations of one
                  graph; sums run in different orders)
  bf16 loss       relative 1e-2; bf16 logits max abs <= 0.15, measured
                  0.031-0.035 on seeds 0-2 (bf16 rounds at different
                  points in the two frameworks' einsums)
  fp32 grads      rtol 1e-4, atol 1e-6
  one AdamW step  atol 1e-7 on the updated parameters in float64 (and
                  2 ulp in float32), both optimizers fed the same
                  gradients (comparing whole training steps
                  would amplify the sign flips of near-zero gradients,
                  since the first Adam step is about lr * sign(g))
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dynolog_tpu.models import train as jtrain
from dynolog_tpu.models import transformer as jtf
from dynolog_tpu.parallel.ring_attention import (
    dense_causal_attention as j_attention,
)
from dynolog_tpu_torch.models import train as ttrain
from dynolog_tpu_torch.models import transformer as ttf
from dynolog_tpu_torch.parallel.ring_attention import (
    dense_causal_attention as t_attention,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


_DTYPES = {"fp32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _configs(dtype="fp32", **kw):
    jdt, tdt = _DTYPES[dtype]
    return (jtf.ModelConfig.tiny(compute_dtype=jdt, **kw),
            ttf.ModelConfig.tiny(compute_dtype=tdt, **kw))


def _setup(dtype="fp32", seed=0, batch=2, seq=16, **kw):
    jcfg, tcfg = _configs(dtype, **kw)
    params = jax.tree.map(np.asarray,
                          jtf.init_params(jax.random.key(seed), jcfg))
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (batch, seq), dtype=np.int32)
    model = ttf.load_jax_params(ttf.Transformer(tcfg, device="cpu"), params)
    return jcfg, params, tokens, model


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_fp32_logits_match_reference():
    jcfg, params, tokens, model = _setup("fp32")
    ref = jax.jit(jtf.forward, static_argnums=2)(params, tokens, jcfg)
    with torch.no_grad():
        out = model(torch.from_numpy(tokens).long())
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _f32(ref), rtol=0, atol=1e-4)


def test_bf16_logits_and_loss_match_reference():
    jcfg, params, tokens, model = _setup("bf16")
    ref = jax.jit(jtf.forward, static_argnums=2)(params, tokens, jcfg)
    tok = torch.from_numpy(tokens).long()
    with torch.no_grad():
        out = model(tok)
        loss = ttrain.loss_fn(model, tok)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _f32(ref),
                               rtol=0, atol=0.15)
    ref_loss = float(jtrain.loss_fn(params, tokens, jcfg))
    assert float(loss) == pytest.approx(ref_loss, rel=1e-2)


def test_loss_matches_reference():
    jcfg, params, tokens, model = _setup("fp32", seed=3)
    ref = float(jtrain.loss_fn(params, tokens, jcfg))
    with torch.no_grad():
        loss = float(ttrain.loss_fn(model, torch.from_numpy(tokens).long()))
    assert loss == pytest.approx(ref, rel=1e-5)


def _torch_grads(model, tokens):
    model.zero_grad(set_to_none=True)
    ttrain.loss_fn(model, torch.from_numpy(tokens).long()).backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _flat_reference(tree, n_layers):
    """JAX tree -> {torch parameter name: numpy array}."""
    out = {k: np.asarray(tree[k]) for k in ("embed", "unembed", "final_norm")}
    for key, stack in tree["layers"].items():
        for i in range(n_layers):
            out[f"layers.{i}.{key}"] = np.asarray(stack[i])
    return out


def test_grads_match_reference():
    jcfg, params, tokens, model = _setup("fp32", seed=1)
    ref = jax.grad(jtrain.loss_fn)(params, tokens, jcfg)
    ref = _flat_reference(ref, jcfg.n_layers)
    grads = _torch_grads(model, tokens)
    assert set(grads) == set(ref)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("dtype,rtol", [("float64", 0.0), ("float32", 2.4e-7)])
def test_adamw_update_matches_optax_on_same_grads(dtype, rtol):
    """float64 on both sides isolates the update rule (atol 1e-7). In
    float32 the two frameworks round the decayed parameter at different
    points, so they differ by up to 1 ulp (rel 1.19e-7 on |p| < 4,
    measured): that case adds rtol of 2 ulp."""
    jcfg, params, tokens, model = _setup("fp32", seed=2)
    grads = jax.grad(jtrain.loss_fn)(params, tokens, jcfg)
    with jax.enable_x64(dtype == "float64"):
        cast = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, dtype)),
                            (params, grads))
        opt = jtrain.make_optimizer()
        updates, _ = opt.update(cast[1], opt.init(cast[0]), cast[0])
        ref = _flat_reference(optax.apply_updates(cast[0], updates),
                              jcfg.n_layers)
    flat_grads = _flat_reference(cast[1], jcfg.n_layers)

    model = model.to(getattr(torch, dtype))
    optimizer = ttrain.make_optimizer(model)
    assert len(optimizer.param_groups) == 1  # norms decay too, as in optax
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(flat_grads[name].copy())
    optimizer.step()
    for name, p in model.named_parameters():
        assert ref[name].dtype == np.dtype(dtype)
        np.testing.assert_allclose(p.detach().numpy(), ref[name],
                                   rtol=rtol, atol=1e-7, err_msg=name)


def test_remat_on_and_off_agree():
    _, params, tokens, model_remat = _setup("fp32", seed=4, remat=True)
    _, _, _, model_plain = _setup("fp32", seed=4, remat=False)
    tok = torch.from_numpy(tokens).long()
    loss_a = ttrain.loss_fn(model_remat, tok)
    loss_b = ttrain.loss_fn(model_plain, tok)
    assert torch.equal(loss_a, loss_b)
    ga = _torch_grads(model_remat, tokens)
    gb = _torch_grads(model_plain, tokens)
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name


@pytest.mark.parametrize("dtype,atol", [("fp32", 1e-5), ("bf16", 1e-2)])
def test_dense_causal_attention_matches_reference(dtype, atol):
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
               for _ in range(3))
    ref = j_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    out = t_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), _f32(ref), rtol=0,
                               atol=atol)


def test_train_step_runs_and_lowers_loss():
    cfg = ttf.ModelConfig.tiny(compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    model, _, step = ttrain.make_train_step(cfg, device="cpu", generator=gen)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16))).long()
    losses = [float(step(tokens)) for _ in range(5)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert next(model.parameters()).device.type == "cpu"


def test_cuda_requested_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        ttf.Transformer(ttf.ModelConfig.tiny())
