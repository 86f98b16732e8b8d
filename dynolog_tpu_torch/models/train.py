"""Training step for the flagship workload, in PyTorch (counterpart of
``dynolog_tpu/models/train.py``): forward, loss, autograd backward and an
AdamW update, unsharded and over a ``("data", "seq", "model")`` mesh.

Where the reference's jitted step lets GSPMD sum the gradients over
``data``/``seq``, the sharded step here all-reduces them after
``backward`` itself; tensor-parallel partials are summed inside the
model (``models/transformer.py``).
"""

from __future__ import annotations

import contextlib

import torch

from dynolog_tpu_torch.models.transformer import ModelConfig, Transformer
from dynolog_tpu_torch.parallel.collectives import (
    all_reduce_grads,
    reduce_from_group,
)
from dynolog_tpu_torch.parallel.mesh import axis


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


def shard_batch(tokens: torch.Tensor, mesh):
    """This rank's part of a global [B, S] batch on a (data, seq, model)
    mesh: (inputs [B/data, S/seq], their next tokens, a mask of the
    positions that have one). The shift is the global one, as the
    reference slices ``[:, :-1]`` on the global array: a sequence
    block's last position takes the next block's first token as its
    target, and only the last position of the whole sequence has none."""
    di, dn = axis(mesh, "data")
    si, sn = axis(mesh, "seq")
    b, s = tokens.shape[0] // dn, tokens.shape[1] // sn
    rows = tokens[di * b:(di + 1) * b]
    nxt = torch.roll(rows, -1, dims=1)
    cols = slice(si * s, (si + 1) * s)
    pos = si * s + torch.arange(s, device=tokens.device)
    valid = pos < tokens.shape[1] - 1
    return rows[:, cols], nxt[:, cols], valid


def sharded_loss_fn(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """loss_fn of the global batch ``tokens`` on a sharded model: every
    rank returns the mean over all B*(S-1) positions. Each rank sums
    the negative log-likelihoods of its block, and the sums are added
    over ``data`` and ``seq`` (backward: identity, since every rank
    computes the same mean)."""
    mesh = model.mesh
    inputs, targets, valid = shard_batch(tokens, mesh)
    logp = torch.log_softmax(model(inputs).float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    total = (nll * valid).sum()
    for name in ("data", "seq"):
        total = reduce_from_group(total, mesh.get_group(name))
    return total / (tokens.shape[0] * (tokens.shape[1] - 1))


def make_sharded_workload(model: torch.nn.Module, loss, sync,
                          lr: float = 3e-4, optimizer=None):
    """Shared scaffolding of the sharded workloads: optimizer and a
    train step. ``loss(model, tokens) -> scalar`` (the same on every
    rank); ``sync()`` sums the gradients over the ranks that hold the
    same parameters, after ``backward``. The optimizer defaults to the
    reference's ``optax.adamw(lr)``: b2 0.999, eps 1e-8 and weight_decay
    1e-4 (torch's default is 0.01). Returns (optimizer, step),
    ``step(tokens) -> loss``."""
    optimizer = optimizer or torch.optim.AdamW(
        model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-4)

    def step(tokens: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        value = loss(model, tokens)
        value.backward()
        sync()
        optimizer.step()
        return value.detach()

    return optimizer, step


def init_sharded(cfg: ModelConfig, mesh, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
    """This rank's shards of the flagship model (the unsharded model's
    weights from ``generator``, sliced) and its AdamW."""
    model = Transformer(cfg, device=device, generator=generator, mesh=mesh)
    return model, make_optimizer(model)


def make_sharded_train_step(cfg: ModelConfig, mesh,
                            device: str | torch.device = "cuda",
                            generator: torch.Generator | None = None):
    """The flagship train step over ``mesh``: (model, optimizer,
    ``train_step(tokens) -> loss``), tokens the global [B, S] batch.
    Gradients are summed over ``data`` and ``seq``; the parameters
    replicated over ``model`` already hold their full gradient."""
    model, optimizer = init_sharded(cfg, mesh, device, generator)
    groups = [mesh.get_group("data"), mesh.get_group("seq")]
    _, step = make_sharded_workload(
        model, sharded_loss_fn,
        lambda: all_reduce_grads(model.parameters(), groups),
        optimizer=optimizer)
    return model, optimizer, step


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
