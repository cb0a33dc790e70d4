"""The VOT toolkit's TraX protocol (counterpart of
pytracking_tpu/evaluation/vot.py).

The toolkit starts the tracker's process and talks to it over TraX: it
sends the first region and each frame's path, and the tracker reports a
region per frame. `VOT(region_format)` is the client the trackers use
(`region()`, `frame()`, `report()`); `run_vot2020` is the VOT2020+ mask
protocol and `run_vot` the polygon protocol of VOT2018/19. Frames are read
with `evaluation.running._read_image`. The `trax` package comes with the
toolkit and is imported only when a session starts;
`evaluation/trax_replay.py` stands in for it without the toolkit.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np

Rectangle = collections.namedtuple("Rectangle", ["x", "y", "width", "height"])
Point = collections.namedtuple("Point", ["x", "y"])
Polygon = collections.namedtuple("Polygon", ["points"])


def make_full_size(x: np.ndarray, output_sz) -> np.ndarray:
    """A mask zero-padded (or cropped) to the image size output_sz =
    (width, height)."""
    if x.shape[0] == output_sz[1] and x.shape[1] == output_sz[0]:
        return x
    pad_x = output_sz[0] - x.shape[1]
    pad_y = output_sz[1] - x.shape[0]
    return np.pad(x, ((0, max(pad_y, 0)), (0, max(pad_x, 0))))[:output_sz[1], :output_sz[0]]


class VOT:
    """TraX client: the handshake happens here, and the first region and
    frame are kept for `region()` and the first `frame()`."""

    def __init__(self, region_format: str, channels=None):
        import trax

        assert region_format in (trax.Region.RECTANGLE, trax.Region.POLYGON, trax.Region.MASK)
        if channels is None:
            channels = ["color"]
        elif channels == "rgbd":
            channels = ["color", "depth"]
        elif channels == "rgbt":
            channels = ["color", "ir"]

        self._trax = trax.Server([region_format], [trax.Image.PATH], channels)
        request = self._trax.wait()
        assert request.type == "initialize"

        self._region = self._convert_region_in(request.region)
        self._image = {k: v.path() for k, v in request.image.items()}
        if len(self._image) == 1:
            self._image = next(iter(self._image.values()))
        self._trax.status(request.region)

    def _convert_region_in(self, region):
        import trax

        if isinstance(region, trax.Polygon):
            return Polygon([Point(x[0], x[1]) for x in region])
        if isinstance(region, trax.Mask):
            return region.array(True)
        return Rectangle(*region.bounds())

    def region(self):
        return self._region

    def report(self, region, confidence: Optional[float] = None):
        import trax

        if isinstance(region, Polygon):
            tregion = trax.Polygon.create([(p.x, p.y) for p in region.points])
        elif isinstance(region, np.ndarray):
            tregion = trax.Mask.create(region)
        else:
            tregion = trax.Rectangle.create(region.x, region.y, region.width, region.height)
        properties = {}
        if confidence is not None:
            properties["confidence"] = confidence
        self._trax.status(tregion, properties)

    def frame(self):
        """The next frame's path (a dict by channel for several channels),
        None when the session ends."""
        if hasattr(self, "_image"):
            image = self._image
            del self._image
            return image
        request = self._trax.wait()
        if request.type == "frame":
            image = {k: v.path() for k, v in request.image.items()}
            if len(image) == 1:
                image = next(iter(image.values()))
            return image
        return None

    def quit(self):
        if hasattr(self, "_trax"):
            self._trax.quit()

    def __del__(self):
        self.quit()


def run_vot2020(tracker_name: str, tracker_param: str, run_id=None, device="cuda"):
    """The VOT2020+ mask protocol: the tracker starts from the mask (and
    its box) and reports a mask per frame where it segments, else its box
    with the presence score as the confidence."""
    from pytracking_tpu_torch.evaluation.running import _read_image
    from pytracking_tpu_torch.evaluation.tracker import Tracker

    tracker_wrapper = Tracker(tracker_name, tracker_param, run_id, device=device)
    handle = VOT("mask")
    selection = handle.region()
    imagefile = handle.frame()
    if not imagefile:
        return
    image = _read_image(imagefile)
    mask = make_full_size(selection, (image.shape[1], image.shape[0]))
    ys, xs = np.nonzero(mask)
    bbox = [float(xs.min()), float(ys.min()),
            float(xs.max() - xs.min() + 1), float(ys.max() - ys.min() + 1)]

    tracker = tracker_wrapper.create_tracker()
    tracker.initialize(image, {"init_bbox": bbox, "init_mask": mask, "object_ids": ["1"]})

    while True:
        imagefile = handle.frame()
        if not imagefile:
            break
        out = tracker.track(_read_image(imagefile))
        if "segmentation" in out:
            handle.report(np.asarray(out["segmentation"], np.uint8))
        else:
            b = out["target_bbox"]
            handle.report(Rectangle(b[0], b[1], b[2], b[3]), out.get("object_presence_score"))


def run_vot(tracker_name: str, tracker_param: str, run_id=None, device="cuda"):
    """The polygon protocol: the first polygon becomes a box by the
    parameters' `vot_anno_conversion_type` ('preserve_area' by default);
    the tracker reports a box per frame."""
    from pytracking_tpu_torch.evaluation.running import _read_image
    from pytracking_tpu_torch.evaluation.tracker import Tracker
    from pytracking_tpu_torch.utils.convert_vot_anno import convert_vot_anno_to_rect

    tracker_wrapper = Tracker(tracker_name, tracker_param, run_id, device=device)
    handle = VOT("polygon")
    vot_anno = [[p.x, p.y] for p in handle.region().points]

    spec = tracker_wrapper.get_parameters()
    conv_type = getattr(spec.params, "vot_anno_conversion_type", "preserve_area")
    bbox = convert_vot_anno_to_rect(np.array(vot_anno).flatten(), conv_type)

    imagefile = handle.frame()
    if not imagefile:
        return
    tracker = tracker_wrapper.create_tracker()
    tracker.initialize(_read_image(imagefile), {"init_bbox": list(bbox)})

    while True:
        imagefile = handle.frame()
        if not imagefile:
            break
        out = tracker.track(_read_image(imagefile))
        b = out["target_bbox"]
        handle.report(Rectangle(b[0], b[1], b[2], b[3]))
