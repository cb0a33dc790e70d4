"""The training step (counterpart of pytracking_tpu/parallel/mesh.py
`make_train_step`), on one device. The JAX module's meshes, batch and
parameter sharding and batched evaluation step become torch.distributed
DDP / FSDP in a later slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from pytracking_tpu_torch.utils.device import ieee_float32


def read_stats(stats: Dict[str, torch.Tensor], device) -> Dict[str, float]:
    """Device stats -> host floats, in one transfer."""
    values = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=device).detach()
                          for v in stats.values()]).tolist()
    return dict(zip(stats, values))


def zero_missing_grads(optimizer: torch.optim.Optimizer) -> None:
    """In a group with weight decay, give a parameter the loss did not
    reach a zero gradient rather than none, so AdamW decays it as
    optax.adamw decays every leaf of its group (torch's optimisers skip a
    parameter without a gradient)."""
    for group in optimizer.param_groups:
        if group.get("weight_decay"):
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)


def make_train_step(actor, optimizer, scheduler=None) -> Callable:
    """The step on a batch already on the device: the actor's forward,
    loss.backward(), optimizer.step(), the scheduler's step, and the stats
    read back to the host in one transfer. Returns (loss, stats) as host
    floats; the loss is stats['Loss/total']. Float32 convolutions and
    matmuls run in IEEE float32, not TF32 (utils/device.ieee_float32), as
    at the port's other entry points. Parameters the loss does not reach
    get zero gradients where weight decay applies (zero_missing_grads)."""

    def train_step(batch) -> Tuple[float, Dict[str, float]]:
        with ieee_float32():
            optimizer.zero_grad(set_to_none=True)
            loss, stats = actor(batch)
            loss.backward()
            zero_missing_grads(optimizer)
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
            host = read_stats(stats, loss.device)
        return host["Loss/total"], host

    return train_step
