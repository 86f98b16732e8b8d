"""Training step for the flagship workload, in PyTorch (counterpart of
``dynolog_tpu/models/train.py``): forward, loss, autograd backward and an
AdamW update. The sharded variants come with the port's parallel
workloads.
"""

from __future__ import annotations

import contextlib

import torch

from dynolog_tpu_torch.models.transformer import ModelConfig, Transformer


def loss_fn(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy, mean over all positions. The full [B,S]
    sequence goes through the model and the shift happens on the logits,
    which become float32 only here, as in the reference."""
    logits = model(tokens)[:, :-1].float()
    targets = tokens[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return nll.mean()


def make_optimizer(model: Transformer, lr: float = 3e-4):
    """AdamW with optax.adamw's settings in the reference: one parameter
    group, so every parameter decays, norms included, as optax does."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.95),
                             eps=1e-8, weight_decay=0.1)


def make_train_step(cfg: ModelConfig, device: str | torch.device = "cuda",
                    generator: torch.Generator | None = None):
    """Builds the model on ``device`` (CUDA unless the caller asks for
    the CPU), its optimizer, and ``train_step(tokens) -> loss`` that
    updates both in place. Returns (model, optimizer, train_step)."""
    model = Transformer(cfg, device=device, generator=generator)
    optimizer = make_optimizer(model)

    def train_step(tokens: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return model, optimizer, train_step


def run_annotated_loop(step_fn, make_batch, steps, client=None,
                       checkpoint_every=0, checkpoint_fn=None):
    """Drives a train step with nested phase annotations.

    Each iteration is wrapped in `client.phase()` spans so the daemon's
    tagstack can attribute wall and host-CPU time to the parts of the
    loop:

        step              the whole iteration
          input           host-side batch production (make_batch(i))
          checkpoint      every ``checkpoint_every`` iterations

    The loss is read back inside the ``step`` span, so host time spent
    waiting for the device lands in the phase that caused it, and
    ``client.step()`` runs after every iteration on this thread — the
    thread whose ops a capture records. With no client the phases are
    nullcontexts. Returns the last loss as a float.
    """
    def phase(name):
        return client.phase(name) if client else contextlib.nullcontext()

    loss = None
    for i in range(steps):
        with phase("step"):
            with phase("input"):
                batch = make_batch(i)
            loss = float(step_fn(batch))
            if checkpoint_every and (i + 1) % checkpoint_every == 0:
                with phase("checkpoint"):
                    if checkpoint_fn is not None:
                        checkpoint_fn(i)
                    elif batch.is_cuda:
                        torch.cuda.synchronize(batch.device)
        if client:
            client.step()
    return loss
