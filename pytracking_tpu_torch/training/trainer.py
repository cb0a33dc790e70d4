"""Trainers: the epoch loop, fail-safe restart, atomic checkpoints and
stats (counterpart of pytracking_tpu/training/trainer.py `AverageMeter`,
`BaseTrainer`, `LTRTrainer`).

The hot loop takes a frame-major numpy batch from the loader, uploads it
from pinned memory without blocking (images NHWC -> NCHW on the device)
and runs one train step (parallel/mesh.make_train_step), whose stats
readback is the step's one host synchronisation; `train_recipe` is the
run every recipe makes of it. Each step's batch carries 'rng_seed', epoch *
1_000_003 + step (the JAX trainer's), which seeds the dropout masks of the
actors whose nets draw them (ToMP, TaMOs): a resumed run draws the same. A checkpoint is
`torch.save` of {'net', 'optimizer', 'scheduler', 'epoch'}, written to
`epNNNN.ckpt.tmp` and renamed with `os.replace`; it is loaded only with
`torch.load(weights_only=True)`.
"""

from __future__ import annotations

import glob
import json
import os
import time
import traceback
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pytracking_tpu_torch.parallel.mesh import make_train_step, read_stats
from pytracking_tpu_torch.training.loader import LTRLoader
from pytracking_tpu_torch.training.optim import adam_per_module
from pytracking_tpu_torch.utils.device import ieee_float32

IMAGE_KEYS = ("train_images", "test_images", "img0", "img1")
# read by the actors on the host (KYS's jitter seeds): kept as CPU tensors
HOST_KEYS = ("jitter_seed",)


def batch_to_device(batch: dict, device) -> dict:
    """A loader's batch -> device tensors (numeric arrays only), uploaded
    from pinned memory without blocking on a card; the images (IMAGE_KEYS)
    go (..., H, W, 3) -> (..., 3, H, W) on the device, and HOST_KEYS stay
    CPU tensors."""
    device = torch.device(device)
    pin = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray) or v.dtype == object:
            continue            # strings, and TaMOs's per-frame {obj_id: box} dicts
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k in HOST_KEYS:
            out[k] = t
            continue
        if pin:
            t = t.pin_memory()
        t = t.to(device, non_blocking=pin)
        out[k] = t.movedim(-1, -3).contiguous() if k in IMAGE_KEYS else t
    return out


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.avg, self.sum, self.count = 0.0, 0.0, 0

    def update(self, val, n=1):
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / self.count


class BaseTrainer:
    """Epoch loop with fail-safe restart: after a crash it reloads the
    latest checkpoint and goes on (up to 10 tries). `restarts` counts the
    restarts; `loaded_checkpoint` is the last checkpoint loaded."""

    def __init__(self, settings, checkpoint_dir: str):
        self.settings = settings
        self._checkpoint_dir = checkpoint_dir
        self.epoch = 0
        self.restarts = 0
        self.loaded_checkpoint: Optional[str] = None

    def train(self, max_epochs: int, load_latest: bool = False, fail_safe: bool = True):
        epoch = -1
        num_tries = 10 if fail_safe else 1
        for i in range(num_tries):
            try:
                if load_latest:
                    self.load_checkpoint()
                for epoch in range(self.epoch + 1, max_epochs + 1):
                    self.epoch = epoch
                    self.train_epoch()
                    self.save_checkpoint()
                break
            except Exception:
                print(f"Training crashed at epoch {epoch}")
                if not fail_safe or i == num_tries - 1:
                    raise
                self.epoch -= 1
                self.restarts += 1
                load_latest = True
                print(traceback.format_exc())
                print("Restarting training from last epoch ...")
        print("Finished training!")

    def train_epoch(self):
        raise NotImplementedError

    def _state_dict(self) -> dict:
        raise NotImplementedError

    def _load_state_dict(self, state: dict):
        raise NotImplementedError

    def save_checkpoint(self) -> str:
        os.makedirs(self._checkpoint_dir, exist_ok=True)
        state = self._state_dict()
        state["epoch"] = self.epoch
        path = os.path.join(self._checkpoint_dir, f"ep{self.epoch:04d}.ckpt")
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        return path

    def load_checkpoint(self, checkpoint: Optional[str] = None) -> bool:
        if checkpoint is None:
            ckpts = sorted(glob.glob(os.path.join(self._checkpoint_dir, "ep*.ckpt")))
            if not ckpts:
                return False
            checkpoint = ckpts[-1]
        state = torch.load(checkpoint, map_location="cpu", weights_only=True)
        self.epoch = int(state.pop("epoch"))
        self._load_state_dict(state)
        self.loaded_checkpoint = checkpoint
        print(f"Loaded checkpoint {checkpoint} (epoch {self.epoch})")
        return True


class LTRTrainer(BaseTrainer):
    """Cycles its loaders each epoch through the train step (the net in
    train mode) or, for a loader that is not `training`, the actor alone
    under no_grad (eval mode); epoch-averaged stats go to a tensorboardX
    writer per loader, or a JSONL file without tensorboardX. `step_log`
    holds each step's epoch, loss, the host's wait on the loader's queue,
    the batch's upload (enqueued, not completed) and the step's wall time
    from the upload to its readback (seconds)."""

    def __init__(self, actor, loaders: List, optimizer, settings, checkpoint_dir: str,
                 scheduler=None, device="cuda", print_interval: int = 10):
        super().__init__(settings, checkpoint_dir)
        self.actor = actor
        self.net = actor.net
        self.loaders = loaders
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.device = torch.device(device)
        self.print_interval = print_interval
        self._train_step = make_train_step(actor, optimizer, scheduler)
        self.stats: Dict[str, Dict[str, AverageMeter]] = {}
        self.step_log: List[dict] = []
        self._tb_writers: Dict[str, object] = {}

    def _tb_writer(self, loader_name: str):
        if loader_name not in self._tb_writers:
            log_dir = os.path.join(self._checkpoint_dir, "tensorboard", loader_name)
            os.makedirs(log_dir, exist_ok=True)
            try:
                from tensorboardX import SummaryWriter
                self._tb_writers[loader_name] = SummaryWriter(log_dir)
            except ImportError:
                self._tb_writers[loader_name] = _JsonlWriter(
                    os.path.join(log_dir, "stats.jsonl"))
        return self._tb_writers[loader_name]

    def _write_epoch_stats(self):
        for name, meters in self.stats.items():
            w = self._tb_writer(name)
            for k, m in meters.items():
                w.add_scalar(k, m.avg, self.epoch)

    def _state_dict(self):
        return {"net": self.net.state_dict(), "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict() if self.scheduler is not None else {}}

    def _load_state_dict(self, state):
        self.net.load_state_dict(state["net"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(state["scheduler"])

    def cycle_dataset(self, loader):
        meters = self.stats.setdefault(loader.name, {})
        self.net.train(loader.training)
        start = t0 = time.perf_counter()
        num_frames = 0
        for i, batch in enumerate(loader, 1):
            t1 = time.perf_counter()
            batch = batch_to_device(batch, self.device)
            batch["rng_seed"] = self.epoch * 1_000_003 + i
            t_up = time.perf_counter()
            if loader.training:
                loss, stats = self._train_step(batch)
            else:
                with torch.no_grad(), ieee_float32():
                    stats = read_stats(self.actor(batch)[1], self.device)
                loss = stats["Loss/total"]
            t2 = time.perf_counter()
            self.step_log.append({"loader": loader.name, "epoch": self.epoch, "step": i,
                                  "loss": loss, "wait_s": t1 - t0, "upload_s": t_up - t1,
                                  "step_s": t2 - t1})
            # sequences: frame-major train_images (N, S, ...), or the
            # matcher's sample-major pairs img0 (S, ...)
            bs = batch["train_images"].shape[1] if "train_images" in batch \
                else batch["img0"].shape[0]
            num_frames += bs
            for k, v in stats.items():
                meters.setdefault(k, AverageMeter()).update(v, bs)
            if i % self.print_interval == 0:
                fps = num_frames / (time.perf_counter() - start)
                print(f"[{loader.name}: {self.epoch}, {i}/{len(loader)}] FPS: {fps:.1f}, "
                      + ", ".join(f"{k}: {m.avg:.4f}" for k, m in meters.items()))
            t0 = time.perf_counter()

    def train_epoch(self):
        for loader in self.loaders:
            if self.epoch % loader.epoch_interval == 0:
                for m in self.stats.get(loader.name, {}).values():
                    m.reset()
                self.cycle_dataset(loader)
        self._write_epoch_stats()


def train_recipe(settings, sampler, net, actor, base_lr: float, module_lrs: Dict[str, float],
                 max_epochs: int, device, freeze_unlisted: bool = False,
                 milestones: Optional[Sequence[int]] = None,
                 weight_decay: Optional[float] = None, step_size: int = 15,
                 stack_dim: int = 1) -> "LTRTrainer":
    """A recipe's training run: `net` on `device`, `actor(net)` on batches of
    settings.batch_size from `sampler` (settings.num_workers loader
    threads; frame-major, or sample-major with stack_dim 0), Adam per module (training/optim.adam_per_module, decayed by 0.2
    every `step_size` epochs, or at the `milestones` epochs; AdamW with
    `weight_decay`), and an LTRTrainer that resumes from the latest
    checkpoint under settings.checkpoint_dir and restarts after a failure.
    Returns the trainer after max_epochs."""
    loader = LTRLoader("train", sampler, training=True, batch_size=settings.batch_size,
                       num_workers=settings.num_workers, stack_dim=stack_dim)
    net = net.to(device)
    optimizer, scheduler = adam_per_module(net, base_lr, module_lrs,
                                           steps_per_epoch=len(loader), step_size=step_size,
                                           gamma=0.2, milestones=milestones,
                                           weight_decay=weight_decay,
                                           freeze_unlisted=freeze_unlisted)
    trainer = LTRTrainer(actor(net), [loader], optimizer, settings, settings.checkpoint_dir,
                         scheduler=scheduler, device=device,
                         print_interval=settings.print_interval)
    trainer.train(max_epochs, load_latest=True, fail_safe=True)
    return trainer


class _JsonlWriter:
    """Scalar writer without tensorboardX: one JSON line per (tag, value, step)."""

    def __init__(self, path: str):
        self.path = path

    def add_scalar(self, tag, value, step):
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": value, "step": step}) + "\n")
