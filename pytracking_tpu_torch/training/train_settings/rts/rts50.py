"""RTS-50's training recipe (counterpart of
pytracking_tpu/training/train_settings/rts/rts50.py): LWL's pipeline (one
train and three test frames, 352x352 crops with their masks) with Gaussian
labels of the classifier branch on its score grid (stride 32, 12x12 for a
4x4 filter: sigma 1/4 over the search area 5), the Lovász hinge on the
fused masks plus LBHinge on the scores, and Adam on the backbone's layer2
to layer4 (4e-5), the mask branch (target model, label encoder, decoder;
8e-5) and the classifier branch (classifier, score encoder, fusion; 2e-4),
the backbone's stem and layer1 frozen, decayed by 0.2 at epochs 25, 115 and
160. The JAX recipe puts the labels on the stride-16 grid (23x23), which
the stride-32 scores (12x12) cannot be compared with. It trains on the
procedural SyntheticVOSVideoDataset unless `datasets` are given; `net`
replaces the seeded RTS-50.
"""

from __future__ import annotations

from pytracking_tpu_torch.models.rts.rts_net import rts50
from pytracking_tpu_torch.training.actors.tracking import RTSActor
from pytracking_tpu_torch.training.processing import RTSProcessing
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.train_settings.lwl import lwl_stage1
from pytracking_tpu_torch.training.train_settings.lwl.lwl_stage1 import OUTPUT_SZ
from pytracking_tpu_torch.training.trainer import train_recipe
from pytracking_tpu_torch.utils.device import resolve_device

CLF_STRIDE = 32
# Adam's learning rate per module; the rest of the net is frozen
BASE_LR = 4e-5
MODULE_LRS = {"feature_extractor.layer2_": 4e-5, "feature_extractor.layer3_": 4e-5,
              "feature_extractor.layer4_": 4e-5, "target_model": 8e-5, "label_encoder": 8e-5,
              "decoder": 8e-5, "clf_encoder": 2e-4, "fusion_module": 2e-4, "classifier": 2e-4}
FREEZE_UNLISTED = True
MILESTONES = (25, 115, 160)


def make_sampler(settings: Settings, datasets=None, samples_per_epoch: int = 2000,
                 seed=None, output_sz: int = OUTPUT_SZ):
    """LWL's sampler with RTSProcessing and the classifier's labels."""
    label_params = {"feature_sz": output_sz // CLF_STRIDE,
                    "sigma_factor": settings.output_sigma_factor / settings.search_area_factor,
                    "kernel_sz": settings.target_filter_sz}
    return lwl_stage1.make_sampler(settings, datasets, samples_per_epoch, seed, output_sz,
                                   processing_cls=RTSProcessing,
                                   label_function_params=label_params)


def make_net(settings: Settings, device="cuda"):
    """The seeded RTS-50."""
    return rts50(device=device)


def make_actor(settings: Settings):
    """The recipe's actor, as a function of the net."""
    return RTSActor


def run(settings: Settings, datasets=None, max_epochs: int = 200,
        samples_per_epoch: int = 2000, net=None, device="cuda", output_sz: int = OUTPUT_SZ):
    """Sets settings.output_sz to `output_sz`, as the JAX recipe does."""
    device = resolve_device(device)
    settings.description = getattr(settings, "description", None) or \
        "RTS-50 (reference recipe defaults)"
    settings.output_sz = output_sz
    sampler = make_sampler(settings, datasets, samples_per_epoch, output_sz=output_sz)
    net = net if net is not None else make_net(settings, device)
    return train_recipe(settings, sampler, net, make_actor(settings), BASE_LR, MODULE_LRS,
                        max_epochs, device, freeze_unlisted=FREEZE_UNLISTED,
                        milestones=MILESTONES)
