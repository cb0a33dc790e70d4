"""ATOM's recipe at the paper's operating point (counterpart of
pytracking_tpu/training/train_settings/bbreg/atom_paper.py): search area 5,
no jitter of the train frame, the test frame's centre jitter 4.5 and scale
jitter 0.5."""

from __future__ import annotations

from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.train_settings.bbreg import atom

make_net = atom.make_net


def operating_point(settings: Settings) -> Settings:
    settings.search_area_factor = 5.0
    settings.center_jitter_factor = {"train": 0, "test": 4.5}
    settings.scale_jitter_factor = {"train": 0, "test": 0.5}
    return settings


def make_sampler(settings: Settings, *args, **kwargs):
    return atom.make_sampler(operating_point(settings), *args, **kwargs)


def run(settings: Settings, **kwargs):
    settings.description = "ATOM paper settings"
    return atom.run(operating_point(settings), **kwargs)
