"""Per-sequence attribute annotations of the evaluation datasets
(counterpart of pytracking_tpu/evaluation/attribute_specs.py). A spec is a
JSON dict with `att_name_long`, `att_name_short` and, per sequence name,
its list of short attribute tags. The OTB, LaSOT, UAV123 and AVisT specs
(published with those benchmarks) are copies in `dataset_attribute_specs/`
next to this module; `env_settings().attribute_specs_path` or the dataset's
root overrides them."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

_SPEC_FILES = {
    "otb": "otb_attributes.json",
    "lasot": "LaSOT_attributes.json",
    "uav": "UAV123_attributes.json",
    "avist": "avist_attributes.json",
    "avist_scenarios": "avist_scenarios.json",
}

_BUNDLED_DIR = os.path.join(os.path.dirname(__file__), "dataset_attribute_specs")


def spec_path(dataset: str) -> Optional[str]:
    from pytracking_tpu_torch.evaluation.environment import env_settings
    env = env_settings()
    fname = _SPEC_FILES.get(dataset, f"{dataset}_attributes.json")
    for root in (getattr(env, "attribute_specs_path", ""),
                 getattr(env, f"{dataset}_path", ""), _BUNDLED_DIR):
        if root:
            p = os.path.join(root, fname)
            if os.path.isfile(p):
                return p
    return None


_cache: Dict[Optional[str], Optional[Dict]] = {}


def load_attribute_spec(dataset: str) -> Optional[Dict]:
    """The spec, cached by its resolved path (the override may change
    between calls)."""
    p = spec_path(dataset)
    if p not in _cache:
        if p is None:
            _cache[p] = None
        else:
            with open(p) as f:
                _cache[p] = json.load(f)
    return _cache[p]


def attribute_names(dataset: str, mode: str = "short") -> List[str]:
    spec = load_attribute_spec(dataset)
    if spec is None:
        return []
    return spec["att_name_short" if mode == "short" else "att_name_long"]


def sequence_attributes(dataset: str, sequence_name: str) -> List[str]:
    spec = load_attribute_spec(dataset)
    if spec is None:
        return []
    return list(spec.get(sequence_name, []))


def filter_names_by_attribute(dataset: str, names: List[str], attribute: str) -> List[str]:
    """The names tagged with `attribute` (its short or long form)."""
    spec = load_attribute_spec(dataset)
    if spec is None:
        raise ValueError(f"No attribute spec for '{dataset}': see "
                         "pytracking_tpu_torch/evaluation/attribute_specs.py for where to put it")
    if attribute not in spec["att_name_short"]:
        if attribute in spec["att_name_long"]:
            attribute = spec["att_name_short"][spec["att_name_long"].index(attribute)]
        else:
            raise ValueError(f"'{attribute}' attribute invalid.")
    return [n for n in names if attribute in spec.get(n, [])]
