"""Split files of the datasets (counterpart of
pytracking_tpu/training/datasets/data_specs.py): one entry per line,
integer sequence indices (GOT-10k) or sequence names (LaSOT, YouTube-VOS),
in the upstream `ltr/data_specs/*.txt` format. Looked for, in order, in
$PYTRACKING_TPU_DATA_SPECS_PATH (the JAX package's variable: one setting
serves both packages), pytracking_tpu_torch/training/data_specs/ and
<dataset root>/data_specs/ or its parent's."""

from __future__ import annotations

import os
from typing import List, Optional


def _candidate_dirs(dataset_root: Optional[str]) -> List[str]:
    dirs = []
    env = os.environ.get("PYTRACKING_TPU_DATA_SPECS_PATH")
    if env:
        dirs.append(env)
    dirs.append(os.path.join(os.path.dirname(__file__), "..", "data_specs"))
    if dataset_root:
        dirs.append(os.path.join(dataset_root, "data_specs"))
        dirs.append(os.path.join(dataset_root, "..", "data_specs"))
    return dirs


def find_data_spec(filename: str, dataset_root: Optional[str] = None) -> str:
    for d in _candidate_dirs(dataset_root):
        p = os.path.join(d, filename)
        if os.path.isfile(p):
            return p
    raise FileNotFoundError(
        f"data spec '{filename}' not found. Searched: "
        f"{[os.path.abspath(d) for d in _candidate_dirs(dataset_root)]}. "
        "Set PYTRACKING_TPU_DATA_SPECS_PATH to a directory holding the "
        "upstream split files (ltr/data_specs/*.txt), or place them under "
        "<dataset root>/data_specs/.")


def load_int_spec(filename: str, dataset_root: Optional[str] = None) -> List[int]:
    with open(find_data_spec(filename, dataset_root)) as f:
        return [int(line.strip()) for line in f if line.strip()]


def load_str_spec(filename: str, dataset_root: Optional[str] = None) -> List[str]:
    with open(find_data_spec(filename, dataset_root)) as f:
        return [line.strip() for line in f if line.strip()]
