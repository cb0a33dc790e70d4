"""Batched multi-stream serving: B independent video streams of one
DiMP-family tracker in one step per frame (counterpart of
pytracking_tpu/parallel/serving.py `BatchedTrackerServer`).

The step is the DiMP tracker's own (`DiMPTracker._step_streams`, written
over a leading stream axis; a single tracker runs it with one stream), after
one batched crop, so a frame of B streams launches about as many kernels as
a frame of one. The classifier refit is split off, as in the JAX server:

  * per frame: the light step (`params.defer_classifier_update=True`):
    crop, backbone, scores, localisation, IoU-Net ascent, memory write; no
    optimiser;
  * every `train_skipping` frames: one optimiser pass over all streams'
    memories with the periodic iteration count, the streams as the
    optimiser's sequence axis, each stream masked on the device by its last
    flag. The cadence lives on the host (all streams share the frame count).

With no hard negatives this is the fused tracker's cadence exactly; a hard
negative's refit waits for the next tick, the serving path's one semantic
difference. A class without `supports_deferred_classifier_update` runs the
fused refit per frame instead: the flags are read back each frame, each
stream's iteration count is chosen on the host, and the optimiser runs once
per non-zero count over the streams that need it. No class the server
accepts today takes that path (DiMP's step always defers); it is the JAX
server's fallback's counterpart, kept for parity with it.

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

from pytracking_tpu_torch.ops.patch import sample_patch
from pytracking_tpu_torch.trackers.dimp import DiMPTracker, stack_states
from pytracking_tpu_torch.utils.device import ieee_float32, resolve_device
from pytracking_tpu_torch.utils.loading import round_to_bf16_


class BatchedTrackerServer:
    """Runs B independent sequences through one batched step per frame.

    Usage:
        server = BatchedTrackerServer(DiMPTracker, params, net)
        server.initialize(frames, bboxes)       # lists of length B
        boxes = server.track(frame_batch)       # (B, H, W, 3) -> (B, 4)

    After each `track` the read-back flags and score peaks are in
    `server.flags` and `server.max_scores`.
    """

    def __init__(self, tracker_cls, params, net, device="cuda", bf16: Optional[bool] = None,
                 **tracker_kwargs):
        """tracker_cls: `DiMPTracker` or a subclass that keeps its step (the
        stream-axis step is DiMP's; KYS and KeepTrack change it).

        bf16: round every float32 weight of a copy of `net` through bf16
        (`round_to_bf16_`, with the BatchNorms' bf16 multipliers), the
        counterpart of the JAX server storing its variables as bf16: the
        layers compute in float32 from the rounded weights, and the
        caller's net is left as it is. None reads
        PYTRACKING_TPU_SERVING_BF16 (default on, the serving default);
        pass False for agreement with the float32 single-stream trackers."""
        if not (isinstance(tracker_cls, type) and issubclass(tracker_cls, DiMPTracker)
                and tracker_cls._track_from_patch is DiMPTracker._track_from_patch):
            raise NotImplementedError(
                f"{getattr(tracker_cls, '__name__', tracker_cls)}: the batched step serves "
                "the DiMP family's own step only")
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
        self.states = stack_states(states)
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

    def _crop(self, frames: torch.Tensor):
        """The search patches (B, 3, s, s) of frames (B, 3, H, W) around each
        stream's target, in one batched crop, and their extents (B, 4)."""
        tr, st = self.tracker, self.states
        p = tr.params
        feat_sz = float(tr._feature_sz)
        centered_pos = st.pos + ((feat_sz + p.kernel_size) % 2) * \
            st.target_scale[:, None] * tr._img_sample_sz / (2 * feat_sz)
        s = p.image_sample_size
        return sample_patch(frames, centered_pos, st.target_scale[:, None] * tr._img_sample_sz,
                            (s, s), mode=p.border_mode, max_scale_change=p.patch_max_scale_change,
                            im_sz=st.image_sz)

    def _step(self, frames: torch.Tensor) -> dict:
        """One step of (B, H, W, 3) frames on the device."""
        patch, coords = self._crop(frames.permute(0, 3, 1, 2).float())
        self.states, out = self.tracker._step_streams(self.states, patch, coords, self._uniform)
        return out

    def _read(self, out: dict) -> np.ndarray:
        """Boxes, score peaks and flags in one copy: the host sync."""
        host = torch.cat([out["target_bbox"], out["max_score"][..., None],
                          out["flag"][..., None].float()], -1).cpu().numpy()
        self.max_scores = host[..., 4]
        self.flags = host[..., 5].astype(np.int64)
        return host[..., :4]

    @torch.no_grad()
    @ieee_float32()
    def track(self, frame_batch) -> np.ndarray:
        """frame_batch (B, H, W, 3) -> boxes (B, 4) [x, y, w, h]. Reads back
        once; the refit (the deferred tick, or the fused per-frame refit)
        is enqueued after the readback, ahead of the next step."""
        return self._track(self._frames(frame_batch))

    def _track(self, frames: torch.Tensor) -> np.ndarray:
        boxes = self._read(self._step(frames))
        self._refit()
        return boxes

    @torch.no_grad()
    @ieee_float32()
    def scan_track(self, frame_batches) -> np.ndarray:
        """frame_batches (T, B, H, W, 3), a device tensor (or a host array,
        uploaded once) -> boxes (T, B, 4). The same steps and ticks as T
        calls of `track`; in deferred mode nothing is read back until the
        end, so the sequence costs one host synchronisation. A
        non-deferring class reads back every frame: its refit is chosen
        from the flags."""
        frames = torch.as_tensor(frame_batches)
        if frames.device.type != self.device.type:
            if self.device.type == "cuda":
                frames = frames.pin_memory()
            frames = frames.to(self.device, non_blocking=True)
        if not self._deferred:
            return np.stack([self._track(f) for f in frames])
        outs = []
        for f in frames:
            outs.append(self._step(f))
            self._refit()
        return self._read({k: torch.stack([o[k] for o in outs]) for k in outs[0]})

    # ---------------------------------------------------------------- refits

    def _refit(self) -> None:
        """After a step: the deferred tick where it falls due, or the fused
        refit chosen from the flags just read back."""
        if not self._deferred:
            self._update_fused(self.flags)
        elif self._needs_update_tick():
            self._update_deferred()

    def _refit_filters(self, num_iter: int, streams=None, mask_by_flag=False) -> None:
        self.states = dataclasses.replace(self.states, target_filter=self.tracker._refit_streams(
            self.states, num_iter, streams, mask_by_flag))

    def _update_deferred(self) -> None:
        self._refit_filters(self.params.net_opt_update_iter, mask_by_flag=True)

    def _update_fused(self, flags) -> None:
        """The fused per-frame refit: each stream's count chosen on the host
        from its flag; one optimiser call per non-zero count over its
        streams, the others' filters untouched."""
        if not self.params.update_classifier:
            return
        groups = {}
        for b, flag in enumerate(flags):
            num_iter = self.tracker._classifier_iterations(int(flag), self._frame_num)
            if num_iter:
                groups.setdefault(num_iter, []).append(b)
        for num_iter, streams in groups.items():
            index = None
            if len(streams) < len(flags):
                index = torch.tensor(streams)
                if self.device.type == "cuda":
                    index = index.pin_memory()
                index = index.to(self.device, non_blocking=True)
            self._refit_filters(num_iter, index)

    def _needs_update_tick(self) -> bool:
        """The fused step's periodic branch fires where (frame_num - 1) %
        train_skipping == 0; frame_num counts the step just run."""
        if not self._deferred:
            return False
        return (self._frame_num - 1) % self.params.train_skipping == 0
