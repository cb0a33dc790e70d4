"""Batched multi-stream serving: B independent video streams of one tracker
in one step per frame (counterpart of pytracking_tpu/parallel/serving.py
`BatchedTrackerServer`).

The step is the tracker class's own, written over a leading stream axis (a
single tracker runs it with one stream), after one batched crop, so a frame
of B streams launches about as many kernels as a frame of one. The server
calls only the class's stream-axis interface (`trackers/base.py`):

  * `_crop_streams(states, frames)`: the patches of B frames in one crop;
  * `_step_streams(states, patches, extents, uniform)`: the step;
  * `stack_states` / `stream_state`: B single-stream states to one batched
    state and back;
  * `_serve_refit`, `_serve_tick_due`, `_serve_reads_flags`: whether, and
    how, a refit follows the step.

The classes served: the DiMP family (DiMP, PrDiMP, SuperDiMP), KYS, ToMP
and TaMOs. A class that changes the single tracker's step without giving
the stream-axis step again (KeepTrack) is refused.

The DiMP family's and KYS's classifier refit is split off, as in the JAX
server:

  * per frame: the light step (`params.defer_classifier_update=True`):
    crop, backbone, scores, localisation, IoU-Net ascent, memory write; no
    optimiser;
  * every `train_skipping` frames: one optimiser pass over all streams'
    memories with the periodic iteration count, the streams as the
    optimiser's sequence axis, each stream masked on the device by its last
    flag. The cadence lives on the host (all streams share the frame count).

With no hard negatives this is the fused tracker's cadence exactly; a hard
negative's refit waits for the next tick, the serving path's one semantic
difference. A DiMP-family class without `supports_deferred_classifier_update`
runs the fused refit per frame instead: the flags are read back each frame,
each stream's iteration count is chosen on the host, and the optimiser runs
once per non-zero count over the streams that need it (the JAX server's
fallback's counterpart). ToMP and TaMOs have no refit: their memory write is
in the step, and `scan_track` reads back once per call.

Entry points run on the card unless `device="cpu"` is passed; without CUDA
the server raises.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from pytracking_tpu_torch.trackers.base import BaseTracker
from pytracking_tpu_torch.utils.device import ieee_float32, resolve_device
from pytracking_tpu_torch.utils.loading import round_to_bf16_


def _defined_in(cls: type, name: str) -> type:
    """The class of `cls`'s MRO whose body defines `name`."""
    return next(c for c in cls.__mro__ if name in vars(c))


def check_servable(tracker_cls) -> None:
    """Raises NotImplementedError unless `tracker_cls` gives the stream-axis
    interface, and gives its stream-axis step again wherever it changes the
    single tracker's step."""
    name = getattr(tracker_cls, "__name__", tracker_cls)
    if not (isinstance(tracker_cls, type) and issubclass(tracker_cls, BaseTracker)
            and tracker_cls._layout is not None and hasattr(tracker_cls, "_step_streams")
            and hasattr(tracker_cls, "_crop_streams")):
        raise NotImplementedError(f"{name}: no stream-axis step to serve")
    step_owner = _defined_in(tracker_cls, "_track_from_patch")
    if not issubclass(_defined_in(tracker_cls, "_step_streams"), step_owner):
        raise NotImplementedError(
            f"{name}: its step ({step_owner.__name__}._track_from_patch) has no stream-axis "
            "counterpart to serve")


class BatchedTrackerServer:
    """Runs B independent sequences through one batched step per frame.

    Usage:
        server = BatchedTrackerServer(DiMPTracker, params, net)
        server.initialize(frames, bboxes)       # lists of length B
        boxes = server.track(frame_batch)       # (B, H, W, 3) -> (B, 4)

    TaMOs returns (B, K, 4): a box per object slot of each stream. After
    each `track` the read-back flags and score peaks are in `server.flags`
    and `server.max_scores`.
    """

    def __init__(self, tracker_cls, params, net, device="cuda", bf16: Optional[bool] = None,
                 **tracker_kwargs):
        """tracker_cls: a class with the stream-axis interface
        (`check_servable`).

        bf16: round every float32 weight of a copy of `net` through bf16
        (`round_to_bf16_`, with the BatchNorms' bf16 multipliers), the
        counterpart of the JAX server storing its variables as bf16: the
        layers compute in their own dtype from the rounded weights, and the
        caller's net is left as it is. None reads
        PYTRACKING_TPU_SERVING_BF16 (default on, the serving default);
        pass False for agreement with the float32 single-stream trackers."""
        check_servable(tracker_cls)
        device = resolve_device(device)
        if bf16 is None:
            bf16 = os.environ.get("PYTRACKING_TPU_SERVING_BF16", "1") == "1"
        if bf16:
            net = round_to_bf16_(copy.deepcopy(net))
        if getattr(tracker_cls, "supports_deferred_classifier_update", False) \
                and hasattr(params, "defer_classifier_update"):
            params = dataclasses.replace(params, defer_classifier_update=True)
            self._deferred = True
        else:
            self._deferred = False
        self.tracker = tracker_cls(params, net, device=device, **tracker_kwargs)
        self.params = params
        self.device = self.tracker.device
        self.bf16 = bf16
        self.states = None
        self.num_streams = 0
        self.flags: Optional[np.ndarray] = None
        self.max_scores: Optional[np.ndarray] = None

    # ---------------------------------------------------------------- draws

    def _uniform(self, shape) -> torch.Tensor:
        """(B,) + shape U[0, 1) draws: what each stream's single-stream
        tracker would draw. Every stream is seeded as the single tracker is
        (its fixed seed) and draws the same shapes, so the streams'
        generators would hold one state: one draw from the tracker's
        generator, expanded over the streams, is each one's. Streams with
        seeds of their own would need a generator each."""
        return self.tracker._uniform(shape).expand((self.num_streams,) + tuple(shape))

    # ---------------------------------------------------------------- host API

    def initialize(self, frames: List[np.ndarray], bboxes: List[list]) -> None:
        """Each stream's own single-stream `initialize` (the generator
        seeded anew for each, as its single tracker's), then the states
        stacked along the stream axis. The frames must share one size: a
        frame batch is one (B, H, W, 3) array."""
        shapes = {np.shape(f) for f in frames}
        if len(shapes) != 1:
            raise ValueError(f"the streams' frames differ in size: {sorted(shapes)}")
        if len(frames) != len(bboxes):
            raise ValueError(f"{len(frames)} frames for {len(bboxes)} boxes")
        states = []
        for frame, bbox in zip(frames, bboxes):
            self.tracker.initialize(frame, {"init_bbox": list(bbox)})
            states.append(self.tracker.state)
        self.tracker.state = None
        self.states = self.tracker.stack_states(states)
        self.num_streams = len(states)

    @property
    def _frame_num(self) -> int:
        return self.states.frame_num

    def _frames(self, frame_batch) -> torch.Tensor:
        """(B, H, W, 3) host frames on the device, uploaded from pinned
        memory without waiting."""
        frames = torch.from_numpy(np.ascontiguousarray(np.asarray(frame_batch)))
        if frames.dim() != 4 or frames.shape[0] != self.num_streams:
            raise ValueError(f"frame batch {tuple(frames.shape)} for "
                             f"{self.num_streams} streams")
        if self.device.type == "cuda":
            frames = frames.pin_memory()
        return frames.to(self.device, non_blocking=True)

    def _step(self, frames: torch.Tensor) -> dict:
        """One step of (B, H, W, 3) frames on the device."""
        patch, coords = self.tracker._crop_streams(self.states,
                                                   frames.permute(0, 3, 1, 2).float())
        self.states, out = self.tracker._step_streams(self.states, patch, coords, self._uniform)
        return out

    def _read(self, out: dict) -> np.ndarray:
        """Boxes, score peaks and flags in one copy: the host sync. Over
        the stream axis (and any object axis)."""
        host = torch.cat([out["target_bbox"], out["max_score"][..., None],
                          out["flag"][..., None].float()], -1).cpu().numpy()
        self.max_scores = host[..., 4]
        self.flags = host[..., 5].astype(np.int64)
        return host[..., :4]

    @torch.no_grad()
    @ieee_float32()
    def track(self, frame_batch) -> np.ndarray:
        """frame_batch (B, H, W, 3) -> boxes (B, 4) [x, y, w, h] ((B, K, 4)
        for TaMOs). Reads back once; a refit (the deferred tick, or the
        fused per-frame refit) is enqueued after the readback, ahead of the
        next step."""
        return self._track(self._frames(frame_batch))

    def _track(self, frames: torch.Tensor) -> np.ndarray:
        boxes = self._read(self._step(frames))
        self._refit()
        return boxes

    @torch.no_grad()
    @ieee_float32()
    def scan_track(self, frame_batches) -> np.ndarray:
        """frame_batches (T, B, H, W, 3), a device tensor (or a host array,
        uploaded once) -> boxes (T, B, 4) ((T, B, K, 4) for TaMOs). The
        same steps and refits as T calls of `track`; unless a refit is
        chosen from the flags, nothing is read back until the end, so the
        sequence costs one host synchronisation. A non-deferring DiMP class
        reads back every frame."""
        frames = torch.as_tensor(frame_batches)
        if frames.device.type != self.device.type:
            if self.device.type == "cuda":
                frames = frames.pin_memory()
            frames = frames.to(self.device, non_blocking=True)
        if self.tracker._serve_reads_flags:
            return np.stack([self._track(f) for f in frames])
        outs = []
        for f in frames:
            outs.append(self._step(f))
            self._refit()
        return self._read({k: torch.stack([o[k] for o in outs]) for k in outs[0]})

    # ---------------------------------------------------------------- refits

    def _refit(self) -> None:
        """After a step: the class's refit (the deferred tick where it falls
        due, the fused refit chosen from the flags just read back, or
        none)."""
        self.states = self.tracker._serve_refit(
            self.states, self.flags if self.tracker._serve_reads_flags else None)
