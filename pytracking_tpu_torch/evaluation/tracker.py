"""A tracker by name: its class, its parameters and its result paths
(counterpart of pytracking_tpu/evaluation/tracker.py).

`pytracking_tpu_torch.parameter.<name>.<param>` exposes
`parameters(device=..., ...)` returning a `TrackerSpec` (and
`precision_kwargs` where it honours the bf16 variables), and
`pytracking_tpu_torch.trackers.<name>` exposes `get_tracker_class()`.
Live video, webcam and the visdom debug UI (`run_video`,
`run_video_generic`) are not ported yet.
"""

from __future__ import annotations

import importlib
import os
from typing import Optional

from pytracking_tpu_torch.evaluation.environment import env_settings
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.utils.device import resolve_device

BF16_VAR = "PYTRACKING_TPU_BF16"
BF16_BACKBONE_VAR = "PYTRACKING_TPU_BF16_BACKBONE"
VMAP_MULTIOBJ_VAR = "PYTRACKING_TPU_VMAP_MULTIOBJ"


def precision_from_env() -> tuple:
    """(PYTRACKING_TPU_BF16, PYTRACKING_TPU_BF16_BACKBONE) as booleans."""
    return (os.environ.get(BF16_VAR, "0") == "1",
            os.environ.get(BF16_BACKBONE_VAR, "0") == "1")


class Tracker:
    """A tracker name and parameter name on a device. `bf16` and
    `bf16_backbone` choose the precision of the parameter module; None
    reads PYTRACKING_TPU_BF16 / PYTRACKING_TPU_BF16_BACKBONE when the
    parameters are built. A CUDA device must exist: there is no CPU
    fallback."""

    def __init__(self, name: str, parameter_name: str, run_id: Optional[int] = None,
                 display_name: Optional[str] = None, device="cuda",
                 bf16: Optional[bool] = None, bf16_backbone: Optional[bool] = None):
        self.name = name
        self.parameter_name = parameter_name
        self.run_id = run_id
        self.display_name = display_name
        self.device = resolve_device(device)
        self.bf16, self.bf16_backbone = bf16, bf16_backbone

        env = env_settings()
        if self.run_id is None:
            self.results_dir = os.path.join(env.results_path, name, parameter_name)
        else:
            self.results_dir = os.path.join(env.results_path, name,
                                            f"{parameter_name}_{run_id:03d}")
        self.segmentation_dir = os.path.join(env.segmentation_path, name, parameter_name)

        tracker_module = importlib.import_module(f"pytracking_tpu_torch.trackers.{name}")
        self.tracker_class = tracker_module.get_tracker_class()
        self._spec = None

    def precision(self) -> tuple:
        """(bf16, bf16_backbone): the explicit choice, else the variables'."""
        env_bf16, env_backbone = precision_from_env()
        return (env_bf16 if self.bf16 is None else self.bf16,
                env_backbone if self.bf16_backbone is None else self.bf16_backbone)

    def parameter_module(self):
        return importlib.import_module(
            f"pytracking_tpu_torch.parameter.{self.name}.{self.parameter_name}")

    def precision_kwargs(self) -> dict:
        """The parameter module's own translation of `precision()`
        (`parameter/precision.py`); none where the module reads neither
        variable."""
        to_kwargs = getattr(self.parameter_module(), "precision_kwargs", None)
        return to_kwargs(*self.precision()) if to_kwargs else {}

    def get_parameters(self) -> TrackerSpec:
        if self._spec is None:
            self._spec = self.parameter_module().parameters(device=self.device,
                                                            **self.precision_kwargs())
        return self._spec

    def create_tracker(self, multiobj: bool = False):
        """The tracker for one sequence. A multi-object sequence gets one
        tracker per object under the MultiObjectWrapper when the class's
        `multiobj_mode` is "parallel" (its batched class, where it has one,
        under PYTRACKING_TPU_VMAP_MULTIOBJ=1); a natively multi-object
        class takes the objects itself."""
        spec = self.get_parameters()
        if multiobj and getattr(self.tracker_class, "multiobj_mode", "parallel") == "parallel":
            vm_cls = getattr(self.tracker_class, "vmap_multiobj_class", None)
            if vm_cls is not None and os.environ.get(VMAP_MULTIOBJ_VAR, "0") == "1":
                return vm_cls(spec.params, spec.net, device=self.device)
            from pytracking_tpu_torch.evaluation.multi_object_wrapper import MultiObjectWrapper
            return MultiObjectWrapper(self.tracker_class, spec.params, spec.net,
                                      device=self.device, tracker_kwargs=spec.tracker_kwargs)
        return self.tracker_class(spec.params, spec.net, device=self.device,
                                  **spec.tracker_kwargs)
