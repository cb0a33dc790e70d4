"""The training settings bag (counterpart of
pytracking_tpu/training/settings.py).

The port keeps its workspace apart from the JAX package's: checkpoints go
under PYTRACKING_TPU_TORCH_WORKSPACE, by default
$PYTRACKING_TPU_TORCH_ROOT/workspace (the root defaults to
~/pytracking_tpu_torch_data, as the harness's). A trainer resumes from the
latest `ep*.ckpt` of its directory, and in a shared one would find the JAX
package's msgpack checkpoints.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def default_workspace() -> str:
    env = os.environ.get("PYTRACKING_TPU_TORCH_WORKSPACE")
    if env:
        return env
    root = os.environ.get("PYTRACKING_TPU_TORCH_ROOT",
                          os.path.expanduser("~/pytracking_tpu_torch_data"))
    return os.path.join(root, "workspace")


@dataclass
class Settings:
    module_name: str = ""
    script_name: str = ""
    project_path: str = ""
    workspace_dir: str = field(default_factory=default_workspace)
    batch_size: int = 8
    num_workers: int = 4
    multi_gpu: bool = False
    print_interval: int = 10
    normalize_mean: tuple = (0.485, 0.456, 0.406)
    normalize_std: tuple = (0.229, 0.224, 0.225)
    search_area_factor: float = 5.0
    output_sigma_factor: float = 1 / 4
    target_filter_sz: int = 4
    feature_sz: int = 18
    output_sz: int = 18 * 16
    center_jitter_factor: dict = field(default_factory=lambda: {"train": 3, "test": 4.5})
    scale_jitter_factor: dict = field(default_factory=lambda: {"train": 0.25,
                                                               "test": 0.5})
    hinge_threshold: float = 0.05

    @property
    def checkpoint_dir(self) -> str:
        return os.path.join(self.workspace_dir, "checkpoints", self.project_path)
