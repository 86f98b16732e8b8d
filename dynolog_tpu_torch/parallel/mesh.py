"""Device mesh and sharding rules for the parallel workloads
(counterpart of ``dynolog_tpu/parallel/mesh.py``).

The same named axes over ``torch.distributed``: a ``DeviceMesh`` over
``("data", "seq", "model")``, one rank per device (NCCL on GPUs, gloo on
the CPU).

Axes:
  * ``data``  — batch data parallelism.
  * ``seq``   — sequence/context parallelism (ring attention rides this).
  * ``model`` — tensor parallelism (attention heads / MLP hidden).
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "seq", "model")


def mesh_shape(n_devices: int) -> tuple[int, int, int]:
    """Factor ``n_devices`` into (data, seq, model) — every axis real when
    the device count allows (8 -> (2, 2, 2)); odd counts fall back to pure
    data parallelism."""
    model = 2 if n_devices % 2 == 0 else 1
    rest = n_devices // model
    seq = 2 if rest % 2 == 0 else 1
    data = rest // seq
    return (data, seq, model)


def make_mesh(device_type: str, shape: tuple[int, ...] | None = None,
              axes: tuple[str, ...] = AXES) -> DeviceMesh:
    """A mesh over every rank of the default process group, which must
    be up. ``shape`` defaults to ``mesh_shape(world size)``."""
    world = dist.get_world_size()
    shape = tuple(shape or mesh_shape(world))
    if math.prod(shape) != world or len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} over axes {axes} != "
                         f"{world} ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def axis(mesh: DeviceMesh, name: str) -> tuple[int, int]:
    """(this rank's index along ``name``, the axis size)."""
    return mesh.get_local_rank(name), mesh.size(mesh.mesh_dim_names.index(
        name))


# The dim of each flagship parameter that is sharded over ``model``
# (None: replicated). The reference's PARAM_SPECS with its leading layer
# dim dropped: the port keeps one module per layer.
PARAM_SPECS = {
    "embed": 1,            # [vocab, d]
    "unembed": 1,          # [d, vocab] (vocab-sharded logits)
    "final_norm": None,    # [d]
    "wq": 1,               # [d, H, hd] — head-sharded
    "wk": 1,
    "wv": 1,
    "wo": 0,               # [H, hd, d]
    "w_gate": 1,           # [d, ff]
    "w_up": 1,
    "w_down": 0,           # [ff, d]
    "ln1": None,           # [d]
    "ln2": None,
}


def shard(x, dim: int | None, index: int, size: int):
    """Slice ``index`` of ``size`` equal slices of ``x`` along ``dim``
    (``x`` itself when ``dim`` is None). Works on numpy arrays and
    tensors."""
    if dim is None:
        return x
    if x.shape[dim] % size:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not "
                         f"split into {size}")
    step = x.shape[dim] // size
    sl = [slice(None)] * x.ndim
    sl[dim] = slice(index * step, (index + 1) * step)
    return x[tuple(sl)]
