"""Tiny example training workloads for trace-path smoke testing, in
PyTorch (counterpart of ``dynolog_tpu/models/examples.py``).

Analogs of the reference's example scripts (reference:
scripts/pytorch/linear_model_example.py, xor.py — the workloads its
profiler walkthrough traces, docs/pytorch_profiler.md:70-76): small
training loops wired to the client shim so `dyno gputrace` (duration-
or iteration-triggered) has something real to capture.

Each function runs on CUDA unless ``device="cpu"`` is passed, and takes
optional starting data and parameters as numpy arrays in the JAX
package's layout (``x @ w``), so a test can start both packages from the
same point. Without them the data and weights are drawn from fixed torch
seeds.

    python -m dynolog_tpu_torch.models.examples xor --steps 2000
    python -m dynolog_tpu_torch.models.examples linear --steps 2000
    python -m dynolog_tpu_torch.models.examples transformer --steps 200
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from dynolog_tpu_torch.models.train import make_train_step, run_annotated_loop
from dynolog_tpu_torch.models.transformer import (
    ModelConfig,
    load_jax_params,
    resolve_device,
)


def _tensor(arr, device) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)


def _normal(shape, seed: int) -> torch.Tensor:
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def run_linear(steps: int, client=None, device: str = "cuda",
               data=None, params=None) -> float:
    """Linear regression on synthetic data (reference:
    linear_model_example.py): MSE, plain SGD at 1e-2. ``data`` is
    (x [1024, 16], y [1024]); ``params`` the starting weights [16]
    (zeros by default)."""
    dev = resolve_device(device)
    if data is None:
        w_true = _normal((16,), 1)
        x = _normal((1024, 16), 0)
        y = x @ w_true + 0.01 * _normal((1024,), 2)
        x, y = x.to(dev), y.to(dev)
    else:
        x, y = (_tensor(a, dev) for a in data)
    w = (torch.zeros(16, device=dev) if params is None
         else _tensor(params, dev))
    w.requires_grad_(True)
    opt = torch.optim.SGD([w], lr=1e-2)

    loss = None
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((x @ w - y) ** 2)
        loss.backward()
        opt.step()
        if client:
            client.step()
    return float(loss.detach())


def run_xor(steps: int, client=None, device: str = "cuda",
            params=None) -> float:
    """Two-layer tanh MLP learning XOR (reference: xor.py): Adam at
    1e-2, binary cross-entropy on logits. ``params`` is the reference's
    dict {w1 [2, 8], b1 [8], w2 [8, 1], b2 [1]}."""
    dev = resolve_device(device)
    x = torch.tensor([[0, 0], [0, 1], [1, 0], [1, 1]], dtype=torch.float32,
                     device=dev)
    y = torch.tensor([0, 1, 1, 0], dtype=torch.float32, device=dev)
    if params is None:
        p = {"w1": _normal((2, 8), 0) * 0.5, "b1": torch.zeros(8),
             "w2": _normal((8, 1), 1) * 0.5, "b2": torch.zeros(1)}
        p = {k: v.to(dev) for k, v in p.items()}
    else:
        p = {k: _tensor(params[k], dev) for k in ("w1", "b1", "w2", "b2")}
    for v in p.values():
        v.requires_grad_(True)
    opt = torch.optim.Adam(p.values(), lr=1e-2)

    loss = None
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        h = torch.tanh(x @ p["w1"] + p["b1"])
        logits = (h @ p["w2"] + p["b2"])[:, 0]
        loss = F.binary_cross_entropy_with_logits(logits, y)
        loss.backward()
        opt.step()
        if client:
            client.step()
    return float(loss.detach())


def run_transformer(steps: int, client=None, device: str = "cuda",
                    params=None, tokens=None,
                    cfg: ModelConfig | None = None) -> float:
    """The flagship workload, one device, tiny config (bf16 unless
    ``cfg`` says otherwise). Runs through ``run_annotated_loop`` so
    `dyno phases` shows live step/input attribution while this workload
    is being traced. ``params`` is the JAX package's
    ``init_params`` tree, ``tokens`` a [4, 64] batch."""
    cfg = cfg or ModelConfig.tiny()
    dev = resolve_device(device)
    model, _, step = make_train_step(
        cfg, device=dev, generator=torch.Generator().manual_seed(0))
    if params is not None:
        load_jax_params(model, params)
    if tokens is None:
        batch = torch.randint(0, cfg.vocab_size, (4, 64),
                              generator=torch.Generator().manual_seed(1))
    else:
        batch = torch.from_numpy(np.array(tokens)).long()
    batch = batch.to(dev)
    return run_annotated_loop(step, lambda i: batch, steps, client=client)


WORKLOADS = {
    "linear": run_linear,
    "xor": run_xor,
    "transformer": run_transformer,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("workload", choices=sorted(WORKLOADS))
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--job-id", default=None)
    p.add_argument("--device", default="cuda",
                   help="Torch device to train on (cuda unless cpu is "
                        "asked for).")
    p.add_argument("--no-client", action="store_true",
                   help="Run without the dynolog client shim.")
    args = p.parse_args(argv)

    client = None
    if not args.no_client:
        from dynolog_tpu_torch.client import enable
        client = enable(job_id=args.job_id)

    t0 = time.time()
    loss = WORKLOADS[args.workload](args.steps, client, device=args.device)
    dt = time.time() - t0
    print(f"{args.workload}: {args.steps} steps in {dt:.2f}s "
          f"({args.steps / dt:.0f} steps/s), final loss {loss:.6f}")
    if client:
        client.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
