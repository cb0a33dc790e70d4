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


def make_train_step(actor, optimizer, scheduler=None) -> Callable:
    """The step on a batch already on the device: the actor's forward,
    loss.backward(), optimizer.step(), the scheduler's step, and the stats
    read back to the host in one transfer. Returns (loss, stats) as host
    floats; the loss is stats['Loss/total']. Float32 convolutions and
    matmuls run in IEEE float32, not TF32 (utils/device.ieee_float32), as
    at the port's other entry points."""

    def train_step(batch) -> Tuple[float, Dict[str, float]]:
        with ieee_float32():
            optimizer.zero_grad(set_to_none=True)
            loss, stats = actor(batch)
            loss.backward()
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
            host = read_stats(stats, loss.device)
        return host["Loss/total"], host

    return train_step
