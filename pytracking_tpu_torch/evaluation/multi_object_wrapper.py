"""One single-object tracker per target (counterpart of
pytracking_tpu/evaluation/multi_object_wrapper.py).

Objects may start on any frame. Each frame's outputs are merged into
{obj_id: value} dicts, segmentations by the tracker's `merge_results` where
it has one, else by the soft-mask argmax. All objects' trackers share one
net on the device.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np


def mask_extent_box(mask) -> list:
    """[x, y, w, h] of a mask's nonzero extent, [0, 0, 1, 1] for an empty
    mask: the box a VOS tracker starts an object from when a benchmark
    (DAVIS, YouTube-VOS) gives its mask alone."""
    ys, xs = np.nonzero(np.asarray(mask))
    if not len(ys):
        return [0.0, 0.0, 1.0, 1.0]
    return [float(xs.min()), float(ys.min()), float(xs.max() - xs.min() + 1),
            float(ys.max() - ys.min() + 1)]


class MultiObjectWrapper:
    multiobj_mode = "parallel"

    def __init__(self, base_tracker_class, params, net=None, device="cuda",
                 tracker_kwargs: Optional[dict] = None):
        self.base_tracker_class = base_tracker_class
        self.params = params
        self.net = net
        self.device = device
        self.tracker_kwargs = tracker_kwargs or {}
        self.trackers: "OrderedDict[Any, Any]" = OrderedDict()
        self.initialized_ids: list = []
        self._frame_num = 0

    def _create(self):
        return self.base_tracker_class(self.params, self.net, device=self.device,
                                       **self.tracker_kwargs)

    def _split_info(self, info: dict) -> Dict[Any, dict]:
        """Each object's init info: its box, and its mask (a label map is
        cut to the object's label); an object given by its mask alone gets
        the mask's extent as its box."""
        info_split = {}
        for obj_id in info.get("object_ids", []):
            d = {"object_ids": [obj_id]}
            for k in ("init_bbox", "init_mask"):
                v = info.get(k)
                if v is None:
                    continue
                if isinstance(v, dict):
                    if obj_id in v:
                        d[k] = v[obj_id]
                elif k == "init_mask":
                    d[k] = (np.asarray(v) == int(obj_id)).astype(np.uint8)
                else:
                    d[k] = v
            if "init_bbox" not in d and "init_mask" in d:
                d["init_bbox"] = mask_extent_box(d["init_mask"])
            info_split[obj_id] = d
        return info_split

    def initialize(self, image, info: dict) -> Optional[dict]:
        self._frame_num = 1
        self.trackers = OrderedDict()
        self.initialized_ids = []
        info = dict(info)
        init_ids = info.get("init_object_ids")
        if init_ids is not None and len(init_ids) == 0:
            return None                  # an empty (re-)start: nothing to track yet
        object_ids = list(info.get("object_ids") or init_ids or ["1"])
        init_ids = list(init_ids) if init_ids is not None else list(object_ids)
        info.setdefault("object_ids", object_ids)
        per_obj = self._split_info({**info, "object_ids": init_ids})
        init_outs = OrderedDict()
        for obj_id in init_ids:
            t = self._create()
            out = t.initialize(image, per_obj[obj_id]) or {}
            if per_obj[obj_id].get("init_bbox") is not None:
                out.setdefault("target_bbox", per_obj[obj_id]["init_bbox"])
            self.trackers[obj_id] = t
            init_outs[obj_id] = out
        self.initialized_ids = list(init_ids)
        if any(init_outs.values()):
            return self._merge(init_outs)
        return {}

    def track(self, image, info: Optional[dict] = None) -> dict:
        self._frame_num += 1
        info = dict(info or {})

        # objects new on this frame: init_object_ids, or ids in object_ids
        # that have no tracker yet
        new_ids = list(info.get("init_object_ids") or [])
        if not new_ids:
            new_ids = [oid for oid in info.get("object_ids", []) if oid not in self.trackers]

        obj_info = {k: v for k, v in info.items()
                    if k not in ("object_ids", "init_object_ids", "init_bbox", "init_mask",
                                 "sequence_object_ids")}
        # the objects started earlier are tracked first; a new object starts
        # on this frame and is not tracked on it
        outputs = OrderedDict((oid, self.trackers[oid].track(image, obj_info))
                              for oid in self.initialized_ids)

        if new_ids:
            per_obj = self._split_info({**info, "object_ids": new_ids})
            prev_output = info.get("previous_output", OrderedDict())
            for oid in new_ids:
                t = self.trackers.get(oid) or self._create()
                obj_init = dict(per_obj[oid])
                obj_init["previous_output"] = prev_output
                out = t.initialize(image, obj_init) or {}
                if per_obj[oid].get("init_bbox") is not None:
                    out.setdefault("target_bbox", per_obj[oid]["init_bbox"])
                self.trackers[oid] = t
                outputs[oid] = out
            self.initialized_ids.extend(new_ids)
        return self._merge(outputs)

    def _merge(self, outputs: Dict[Any, dict]) -> dict:
        """The tracker's `merge_results` if it has one, else boxes and
        presence scores by object and the argmax over the objects' soft
        masks above the segmentation threshold."""
        first = next(iter(self.trackers.values()), None)
        if first is not None and hasattr(first, "merge_results"):
            return first.merge_results(outputs)
        merged: dict = {"target_bbox": {}, "object_presence_score": {}}
        seg_scores = {}
        for oid, out in outputs.items():
            if "target_bbox" in out:
                merged["target_bbox"][oid] = out["target_bbox"]
            if "object_presence_score" in out:
                merged["object_presence_score"][oid] = out["object_presence_score"]
            seg = out.get("segmentation_soft", out.get("segmentation"))
            if seg is not None:
                seg_scores[oid] = np.asarray(seg, np.float32)
        if not merged["object_presence_score"]:
            merged.pop("object_presence_score")
        if seg_scores:
            ids = list(seg_scores)
            stack = np.stack([seg_scores[i] for i in ids])      # (N, H, W)
            thr = getattr(self.params, "segmentation_threshold", 0.5)
            obj_ids = np.array([0] + [int(i) for i in ids], np.uint8)
            merged["segmentation"] = obj_ids[
                np.where(stack.max(axis=0) > thr, stack.argmax(axis=0) + 1, 0)]
        return merged
