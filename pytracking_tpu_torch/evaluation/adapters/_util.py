"""Helpers of the dataset adapters (counterpart of
pytracking_tpu/evaluation/adapters/_util.py)."""

from __future__ import annotations

import os

import numpy as np


def load_text(path: str, delimiter=",", dtype=np.float64) -> np.ndarray:
    """An annotation file read with the given delimiter(s), then with
    whitespace."""
    delims = [delimiter] if isinstance(delimiter, str) else list(delimiter)
    for d in delims + [None]:
        try:
            return np.loadtxt(path, delimiter=d, dtype=dtype)
        except Exception:
            continue
    raise IOError(f"Cannot parse annotation file {path}")


def list_frames(path: str, exts=(".jpg", ".jpeg", ".png", ".bmp")) -> list:
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if os.path.splitext(f)[1].lower() in exts)


def dataset_root(env_settings, name: str) -> str:
    """The directory `env_settings.<name>` names (PYTRACKING_TPU_<NAME>, or
    a `local.py`); raises FileNotFoundError where it is empty or not a
    directory, so that a missing tree never reads as an empty dataset."""
    path = getattr(env_settings, name)
    if not path or not os.path.isdir(path):
        raise FileNotFoundError(
            f"dataset path {name} is {path!r}, which is not a directory: set "
            f"PYTRACKING_TPU_{name.upper()} (or {name} in "
            "pytracking_tpu_torch/evaluation/local.py) to the benchmark's root")
    return path
