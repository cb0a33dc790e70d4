"""ATOM's GMM-sampling recipe (counterpart of
pytracking_tpu/training/train_settings/bbreg/atom_gmm_sampl.py): the
prob-ML recipe, whose proposals are drawn from the Gaussian mixture around
the target."""

from __future__ import annotations

from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.train_settings.bbreg import atom_prob_ml

make_net = atom_prob_ml.make_net
make_sampler = atom_prob_ml.make_sampler


def run(settings: Settings, **kwargs):
    settings.description = "ATOM GMM-sampling (reference recipe defaults)"
    return atom_prob_ml.run(settings, **kwargs)
