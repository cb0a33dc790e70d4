"""Where the harness reads datasets and writes results (counterpart of
pytracking_tpu/evaluation/environment.py).

The port keeps its results apart from the JAX package's: its root is
PYTRACKING_TPU_TORCH_ROOT (default ~/pytracking_tpu_torch_data), and its
output paths are overridden by PYTRACKING_TPU_TORCH_<NAME>
(PYTRACKING_TPU_TORCH_RESULTS_PATH, ...). Were both packages to write under
one root, the port's skip-if-done would find the JAX package's result files
and skip its own run. The dataset paths keep the JAX package's variables
(PYTRACKING_TPU_LASOT_PATH, ...), so one setting serves both packages. A
module `pytracking_tpu_torch.evaluation.local` with `local_env_settings()`
replaces all of it.
"""

from __future__ import annotations

import importlib
import os

# written by the harness; every other path is read
OUTPUT_PATHS = ("results_path", "segmentation_path", "network_path", "result_plot_path")


class EnvSettings:
    def __init__(self):
        root = os.environ.get("PYTRACKING_TPU_TORCH_ROOT",
                              os.path.expanduser("~/pytracking_tpu_torch_data"))
        self.results_path = os.path.join(root, "tracking_results")
        self.segmentation_path = os.path.join(root, "segmentation_results")
        self.network_path = os.path.join(root, "networks")
        self.result_plot_path = os.path.join(root, "result_plots")
        self.otb_path = ""
        self.nfs_path = ""
        self.uav_path = ""
        self.tpl_path = ""
        self.vot_path = ""
        self.got10k_path = ""
        self.got10k_mask_path = ""
        self.lasot_path = ""
        self.lasot_mask_path = ""
        self.lasot_extension_subset_path = ""
        self.trackingnet_path = ""
        self.trackingnet_mask_path = ""
        self.davis_dir = ""
        self.youtubevos_dir = ""
        self.avist_path = ""
        self.oxuva_path = ""
        self.lagot_path = ""
        self.mobiface_path = ""
        self.attribute_specs_path = ""

        for name in list(vars(self)):
            prefix = "PYTRACKING_TPU_TORCH_" if name in OUTPUT_PATHS else "PYTRACKING_TPU_"
            env = os.environ.get(prefix + name.upper())
            if env:
                setattr(self, name, env)


_env_settings = None


def env_settings() -> EnvSettings:
    """The settings, made once per process (`reset_env_settings` drops them)."""
    global _env_settings
    if _env_settings is None:
        try:
            local = importlib.import_module("pytracking_tpu_torch.evaluation.local")
            _env_settings = local.local_env_settings()
        except ImportError:
            _env_settings = EnvSettings()
    return _env_settings


def reset_env_settings() -> None:
    """Forget the settings: the next `env_settings()` reads the environment
    again."""
    global _env_settings
    _env_settings = None
