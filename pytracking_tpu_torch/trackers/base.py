"""Tracker interface (counterpart of pytracking_tpu/trackers/base.py).

`initialize(image, info) -> dict` and `track(image, info) -> dict`, with
'target_bbox' (x, y, w, h) and 'object_presence_score' in the outputs. A
tracker keeps its per-frame state as fixed-shape tensors on its device;
`track` reads back only the small output dict. The JAX package's shape
buckets and jit plumbing are XLA machinery and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from pytracking_tpu_torch.utils.device import resolve_device


def take(x: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """x[ind] for a 0-dim index tensor, without reading it on the host."""
    return x.index_select(0, ind.reshape(1).long())[0]


def masked_slot_set(buf: torch.Tensor, ind: torch.Tensor, value: torch.Tensor,
                    do_update: torch.Tensor) -> None:
    """In place: buf[ind] = value where do_update, else buf[ind] keeps its
    contents. Only the chosen slot is read and written; `ind` stays on the
    device."""
    slot = torch.where(do_update, value, take(buf, ind))
    buf.index_copy_(0, ind.reshape(1).long(), slot[None])


def masked_stream_slots_set(writes, ind: torch.Tensor, do_update: torch.Tensor) -> None:
    """`masked_slot_set` over a stream axis, in place, for each (buf, value)
    of `writes`: buf (M, B, ...)[ind[b], b] = value[b] where do_update[b],
    by one indexed write per buffer; ind and do_update (B,) stay on the
    device."""
    B = do_update.shape[0]
    streams = torch.arange(B, device=do_update.device)
    for buf, value in writes:
        keep = do_update.reshape((B,) + (1,) * (value.dim() - 1))
        buf.index_put_((ind, streams), torch.where(keep, value, buf[ind, streams]))


@dataclass(frozen=True)
class StreamLayout:
    """How a tracker's single-stream state maps onto its stream-axis twin
    (the batched server's state, `parallel/serving.py`): every tensor field
    gains a stream axis B, first, except the `memory` fields, which take it
    second ((M, B, ...): the memory's slot axis stays first), and the
    `leading_one` fields, whose leading axis of 1 already is the stream
    axis. `frame_num`, a host count, is shared by the streams."""
    single: type
    batched: type
    memory: Tuple[str, ...] = ()
    leading_one: Tuple[str, ...] = ()

    @property
    def tensors(self) -> Tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(self.single) if f.name != "frame_num")

    def _by_layout(self, name, memory, leading_one, other):
        return memory if name in self.memory else \
            leading_one if name in self.leading_one else other

    def stack(self, states: Sequence) -> Any:
        """B single-stream states (at one frame count) -> one batched state."""
        frame_nums = {s.frame_num for s in states}
        if len(frame_nums) != 1:
            raise ValueError(f"streams at different frame counts {sorted(frame_nums)}")
        return self.batched(frame_num=states[0].frame_num, **{
            n: self._by_layout(n, lambda xs: torch.stack(xs, 1), torch.cat, torch.stack)(
                [getattr(s, n) for s in states]) for n in self.tensors})

    def stream(self, state, b: int) -> Any:
        """Stream b's state as a single-stream state, every tensor a copy
        (a single tracker writes its memory in place)."""
        return self.single(frame_num=state.frame_num, **{
            n: self._by_layout(n, lambda x: x[:, b], lambda x: x[b:b + 1], lambda x: x[b])(
                getattr(state, n)).clone() for n in self.tensors})

    def one_stream(self, state, names: Sequence[str]) -> dict:
        """The named fields of a single-stream state as one stream of a
        batch, every tensor a view (the step's in-place memory writes reach
        it)."""
        return {n: self._by_layout(n, lambda x: x[:, None], lambda x: x, lambda x: x[None])(
            getattr(state, n)) for n in names}

    def unbatch(self, fields: dict) -> dict:
        """`one_stream`'s inverse on stream-axis tensors of one stream."""
        return {n: self._by_layout(n, lambda x: x[:, 0], lambda x: x, lambda x: x[0])(x)
                for n, x in fields.items()}

    def as_batch(self, state) -> Any:
        """A single-stream state as a batch of one (views)."""
        return self.batched(frame_num=state.frame_num, **self.one_stream(state, self.tensors))

    def from_batch(self, state, streams) -> Any:
        """`state` with the fields of `streams`, a batch of one."""
        return dataclasses.replace(state, frame_num=streams.frame_num, **self.unbatch(
            {n: getattr(streams, n) for n in self.tensors}))


def one_stream_step(layout: StreamLayout, step, state, *args):
    """A stream-axis step `step(states, *stream_args)` run on one stream:
    the single state viewed as a batch of one, each tensor argument given a
    stream axis of 1 (a callable argument is passed as it is), the outputs
    taken back out of it."""
    args = [a[None] if isinstance(a, torch.Tensor) else a for a in args]
    streams, out = step(layout.as_batch(state), *args)
    return layout.from_batch(state, streams), {k: v[0] for k, v in out.items()}


@dataclass
class TrackerSpec:
    """What a parameter module returns: tracker parameters, the network and
    further keyword arguments of the tracker (KeepTrack's matching net)."""
    params: Any
    net: nn.Module
    tracker_kwargs: Dict[str, Any] = field(default_factory=dict)


class BaseTracker:
    # how the harness runs several objects (evaluation/tracker.py):
    # "parallel" is one tracker per object under the MultiObjectWrapper,
    # "default" a tracker that takes them all itself (TaMOs)
    multiobj_mode = "parallel"

    def __init__(self, params, device="cuda"):
        self.params = params
        self.device = resolve_device(device)

    def _image_tensor(self, image) -> torch.Tensor:
        """Host frame (H, W, 3) -> (3, H, W) float32 on the tracker's device.
        A card gets the frame from pinned memory without waiting: a pageable
        upload would synchronise the host with the card's queue."""
        frame = torch.from_numpy(np.ascontiguousarray(np.asarray(image)))
        if self.device.type == "cuda":
            frame = frame.pin_memory()
        return frame.to(self.device, non_blocking=True).permute(2, 0, 1).float()

    def initialize(self, image, info: Dict[str, Any]) -> Optional[dict]:
        raise NotImplementedError

    def track(self, image, info: Optional[dict] = None) -> dict:
        raise NotImplementedError

    # ------------------------------------------------ the batched server's interface
    # (parallel/serving.py). A class serves B streams when it has a `_layout`
    # and defines `_crop_streams(states, frames)` -> (patches, extents) and
    # `_step_streams(states, patches, extents, uniform)` -> (states, outputs
    # with a leading stream axis), its single tracker the one-stream case.

    _layout: Optional[StreamLayout] = None

    @classmethod
    def stack_states(cls, states: Sequence) -> Any:
        """B single-stream states (at one frame count) -> one batched state."""
        return cls._layout.stack(states)

    @classmethod
    def stream_state(cls, state, b: int) -> Any:
        """Stream b's state as a single-stream state, every tensor a copy."""
        return cls._layout.stream(state, b)

    @property
    def _serve_reads_flags(self) -> bool:
        """Whether the refit after a served step is chosen from the step's
        flags on the host (then every step reads back)."""
        return False

    def _serve_tick_due(self, frame_num: int) -> bool:
        """Whether a periodic refit follows the step that reached
        `frame_num`."""
        return False

    def _serve_refit(self, states, flags: Optional[np.ndarray] = None):
        """The refit after a served step, enqueued after its readback
        (`flags`, the host's copy of the step's flags, where
        `_serve_reads_flags`). None by default: the class has no refit."""
        return states
