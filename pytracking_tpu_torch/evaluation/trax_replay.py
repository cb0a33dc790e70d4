"""A stand-in of the VOT toolkit's `trax` module that replays a sequence
through the TraX entries (`evaluation/vot.run_vot2020`, `run_vot`) in the
same process, without the toolkit: its server hands the tracker the first
region and each frame's path, one request at a time, and records every
status the tracker reports.

    with replay(frame_paths, region) as session:
        run_vot2020("dimp", "dimp50")
    session.reports    # Report(kind, region, properties): the echo of the
                       # first region, then one per frame after the first

`region` is what the toolkit sends first: a Rectangle, a Polygon or a Mask
of this module (`rectangle`, `polygon`, `mask` build them). While the
context is open `sys.modules["trax"]` is this module. It implements the
part of the trax Python API that a TraX client uses, nothing more.
"""

from __future__ import annotations

import collections
import contextlib
import sys

import numpy as np

Report = collections.namedtuple("Report", ["kind", "region", "properties"])
Request = collections.namedtuple("Request", ["type", "region", "image"])


class Region:
    RECTANGLE = "rectangle"
    POLYGON = "polygon"
    MASK = "mask"


class Image:
    PATH = "path"


class _PathImage:
    def __init__(self, path):
        self._path = path

    def path(self):
        return self._path


class Rectangle:
    kind = Region.RECTANGLE

    def __init__(self, x, y, width, height):
        self._bounds = (float(x), float(y), float(width), float(height))

    @classmethod
    def create(cls, x, y, width, height):
        return cls(x, y, width, height)

    def bounds(self):
        return self._bounds

    def value(self):
        return self._bounds


class Polygon:
    kind = Region.POLYGON

    def __init__(self, points):
        self._points = tuple((float(x), float(y)) for x, y in points)

    @classmethod
    def create(cls, points):
        return cls(points)

    def __iter__(self):
        return iter(self._points)

    def __len__(self):
        return len(self._points)

    def value(self):
        return self._points


class Mask:
    """A mask whose offset is (0, 0): `array(True)` gives it as stored,
    which may be smaller than the frame (the client pads it)."""
    kind = Region.MASK

    def __init__(self, array):
        self._array = np.array(array, np.uint8)

    @classmethod
    def create(cls, array):
        return cls(array)

    def array(self, normalize=False):
        return self._array.copy()

    def value(self):
        return self._array


def rectangle(x, y, width, height):
    return Rectangle(x, y, width, height)


def polygon(points):
    """points: (N, 2) or flat (x1, y1, x2, y2, ...)."""
    return Polygon(np.asarray(points, np.float64).reshape(-1, 2).tolist())


def mask(array):
    return Mask(array)


class Session:
    """The frames and first region one tracker run is served, and what it
    reported."""

    def __init__(self, frames, region, channels=("color",)):
        self.frames = list(frames)
        self.region = region
        self.channels = tuple(channels)
        self.reports = []
        self.served = 0
        self.closed = False

    def request(self):
        if self.served >= len(self.frames):
            return Request("quit", None, {})
        image = {c: _PathImage(self.frames[self.served]) for c in self.channels}
        kind = "initialize" if self.served == 0 else "frame"
        self.served += 1
        return Request(kind, self.region if kind == "initialize" else None, image)


_session = None


class Server:
    def __init__(self, region_formats, image_formats, channels=("color",)):
        if _session is None:
            raise RuntimeError("trax_replay: no session; open one with replay(...)")
        if _session.region.kind not in region_formats:
            raise ValueError(f"trax_replay: the tracker asks for {region_formats}, the "
                             f"session holds a {_session.region.kind}")
        if Image.PATH not in image_formats:
            raise ValueError(f"trax_replay: image formats {image_formats}: only paths")
        _session.channels = tuple(channels)
        self._session = _session

    def wait(self):
        return self._session.request()

    def status(self, region, properties=None):
        self._session.reports.append(Report(region.kind, region.value(),
                                            dict(properties or {})))

    def quit(self):
        self._session.closed = True


@contextlib.contextmanager
def replay(frames, region, channels=("color",)):
    """Serve `frames` (paths) from `region` to the TraX client a tracker
    opens inside the block; yields the Session with its reports."""
    global _session
    saved = sys.modules.get("trax")
    _session = Session(frames, region, channels)
    sys.modules["trax"] = sys.modules[__name__]
    try:
        yield _session
    finally:
        _session = None
        if saved is None:
            sys.modules.pop("trax", None)
        else:
            sys.modules["trax"] = saved
