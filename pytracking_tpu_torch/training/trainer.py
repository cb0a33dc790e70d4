"""Trainers: the epoch loop, fail-safe restart, atomic checkpoints and
stats (counterpart of pytracking_tpu/training/trainer.py `AverageMeter`,
`BaseTrainer`, `LTRTrainer`).

The hot loop takes a frame-major numpy batch from the loader, uploads it
from pinned memory without blocking (images NHWC -> NCHW on the device)
and runs one train step (parallel/mesh.make_train_step), whose stats
readback is the step's one host synchronisation. A checkpoint is
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
from typing import Dict, List, Optional

import numpy as np
import torch

from pytracking_tpu_torch.parallel.mesh import make_train_step, read_stats
from pytracking_tpu_torch.utils.device import ieee_float32

IMAGE_KEYS = ("train_images", "test_images")


def batch_to_device(batch: dict, device) -> dict:
    """A loader's batch -> device tensors (arrays only), uploaded from
    pinned memory without blocking on a card; the images go NHWC -> NCHW
    on the device."""
    device = torch.device(device)
    pin = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if pin:
            t = t.pin_memory()
        t = t.to(device, non_blocking=pin)
        out[k] = t.permute(0, 1, 4, 2, 3).contiguous() if k in IMAGE_KEYS else t
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
            bs = batch["train_images"].shape[1]
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


class _JsonlWriter:
    """Scalar writer without tensorboardX: one JSON line per (tag, value, step)."""

    def __init__(self, path: str):
        self.path = path

    def add_scalar(self, tag, value, step):
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": value, "step": step}) + "\n")
