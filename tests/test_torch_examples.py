"""The port's example workloads against the JAX package's.

Each port function starts from the data and parameters the JAX function
draws (recomputed here from the same jax.random keys and carried over
through numpy) and must reach the JAX final loss, on the CPU in float32.
Tolerances, relative on the final loss:

  linear       200 steps of SGD   1e-5  (measured 0.0; 1.7e-7 at 50 steps)
  xor          800 steps of Adam  1e-4  (measured 2.9e-5: Adam's
                                         normalised steps carry the
                                         frameworks' rounding near
                                         convergence)
  transformer  3 steps of AdamW, fp32   1e-4 (measured 2.5e-7)
               3 steps of AdamW, bf16   1e-3 (measured 1.4e-5; the
                                         bf16 loss of test_torch_model
                                         is held to 1e-2)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynolog_tpu.models import examples as jex
from dynolog_tpu.models import transformer as jtf
from dynolog_tpu_torch.models import examples as tex
from dynolog_tpu_torch.models import transformer as ttf


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _linear_data():
    """examples.py:run_linear's draws."""
    w_true = jax.random.normal(jax.random.key(1), (16,))
    x = jax.random.normal(jax.random.key(0), (1024, 16))
    y = x @ w_true + 0.01 * jax.random.normal(jax.random.key(2), (1024,))
    return np.asarray(x), np.asarray(y)


def _xor_params():
    """examples.py:run_xor's draws."""
    k1, k2 = jax.random.split(jax.random.key(0))
    return {"w1": np.asarray(jax.random.normal(k1, (2, 8)) * 0.5),
            "b1": np.zeros(8, np.float32),
            "w2": np.asarray(jax.random.normal(k2, (8, 1)) * 0.5),
            "b2": np.zeros(1, np.float32)}


def test_linear_matches_reference():
    ref = jex.run_linear(200)
    got = tex.run_linear(200, device="cpu", data=_linear_data(),
                         params=np.zeros(16, np.float32))
    assert got == pytest.approx(ref, rel=1e-5)
    assert got < 0.05  # converged, as tests/test_examples.py asks


def test_xor_matches_reference():
    ref = jex.run_xor(800)
    got = tex.run_xor(800, device="cpu", params=_xor_params())
    assert got == pytest.approx(ref, rel=1e-4)
    assert got < 0.1


@pytest.mark.parametrize("dtype,rel", [("fp32", 1e-4), ("bf16", 1e-3)])
def test_transformer_matches_reference(monkeypatch, dtype, rel):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tiny = jtf.ModelConfig.tiny
    # examples.py:run_transformer builds ModelConfig.tiny() inside; the
    # fp32 case runs it at float32 compute.
    monkeypatch.setattr(jtf.ModelConfig, "tiny", classmethod(
        lambda cls, **kw: tiny(**{"compute_dtype": jdt, **kw})))
    cfg = jtf.ModelConfig.tiny()
    params = jax.tree.map(np.asarray,
                          jtf.init_params(jax.random.key(0), cfg))
    tokens = np.asarray(jax.random.randint(
        jax.random.key(1), (4, 64), 0, cfg.vocab_size))
    ref = jex.run_transformer(3)
    got = tex.run_transformer(
        3, device="cpu", params=params, tokens=tokens,
        cfg=ttf.ModelConfig.tiny(compute_dtype=tdt))
    assert got == pytest.approx(ref, rel=rel)


def test_default_draws_converge_on_cpu():
    """Without starting points the port draws its own (torch seeds)."""
    assert tex.run_linear(200, device="cpu") < 0.05
    assert tex.run_xor(800, device="cpu") < 0.1
    assert np.isfinite(tex.run_transformer(2, device="cpu"))


def test_examples_cli_no_client(capsys):
    assert tex.main(["linear", "--steps", "50", "--no-client",
                     "--device", "cpu"]) == 0
    assert "linear: 50 steps" in capsys.readouterr().out


def test_cuda_requested_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tex.run_linear, tex.run_xor, tex.run_transformer):
        with pytest.raises(RuntimeError, match="CUDA is unavailable"):
            fn(1)
