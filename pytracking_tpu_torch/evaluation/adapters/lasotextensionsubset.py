"""The LaSOT extension subset (counterpart of
pytracking_tpu/evaluation/adapters/lasotextensionsubset.py): LaSOT's layout
under `lasot_extension_subset_path`."""

from __future__ import annotations

from pytracking_tpu_torch.evaluation.adapters.lasot import LaSOTDataset


class LaSOTExtensionSubsetDataset(LaSOTDataset):
    path_setting = "lasot_extension_subset_path"
    dataset_name = "lasot_extension_subset"

    def __init__(self):
        super().__init__()
