"""KeepTrack's training recipe for the target candidate matching net
(counterpart of pytracking_tpu/training/train_settings/keep_track/
keep_track.py): pairs of frames with K = 8 candidate slots each, the
balanced assignment NLL, and Adam at 1e-4 on the whole net, decayed by 0.2
every 6 epochs. The upstream recipe reads candidate pairs dumped from
SuperDiMP runs; as in the JAX recipe, `SyntheticCandidateDataset` stands in
unless `datasets` are given. `net` replaces the seeded matching net.
"""

from __future__ import annotations

import numpy as np

from pytracking_tpu_torch.evaluation.adapters.synthetic import render_synthetic_frame
from pytracking_tpu_torch.models.tcm.target_candidate_matching import \
    target_candidate_matching_net_resnet50
from pytracking_tpu_torch.training.actors.tracking import TCMActor
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.trainer import train_recipe
from pytracking_tpu_torch.utils.device import resolve_device

# Adam on every parameter at BASE_LR
BASE_LR = 1e-4
MODULE_LRS: dict = {}
FREEZE_UNLISTED = False
STEP_SIZE = 6
STACK_DIM = 0                        # batches are sample-major: (S, ...)
IM_SZ = 288
K = 8


class SyntheticCandidateDataset:
    """Candidate pairs over synthetic frames: sample i renders two frames of
    sequence i % 16 at random times, and K candidate cells on frame 0's
    1/16 grid moved by at most one cell on frame 1's; the ground-truth
    matching is the identity over the matchable slots (each with
    probability 0.7), the rest to the dustbin. Sample i draws from
    np.random.RandomState(i) alone."""

    def __init__(self, num_samples: int = 2000, K: int = K, im_sz: int = IM_SZ):
        self.num_samples = num_samples
        self.K = K
        self.im_sz = im_sz

    def __len__(self):
        return self.num_samples

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        K, S = self.K, self.im_sz
        img0 = render_synthetic_frame(i % 16, rng.randint(0, 20), S, S)
        img1 = render_synthetic_frame(i % 16, rng.randint(0, 20), S, S)
        coords = rng.randint(0, S // 16, (K, 2))
        jitter = np.clip(coords + rng.randint(-1, 2, (K, 2)), 0, S // 16 - 1)
        matchable = rng.rand(K) > 0.3
        gt_matches = np.where(matchable, np.arange(K), -1)
        gt_assign = np.zeros((K, K), np.float32)
        gt_assign[np.arange(K)[matchable], np.arange(K)[matchable]] = 1.0
        return {
            "img0": img0.astype(np.float32), "img1": img1.astype(np.float32),
            "tsm_coords0": coords.astype(np.int32), "tsm_coords1": jitter.astype(np.int32),
            "img_coords0": (coords * 16).astype(np.float32),
            "img_coords1": (jitter * 16).astype(np.float32),
            "scores0": rng.rand(K).astype(np.float32),
            "scores1": rng.rand(K).astype(np.float32),
            "gt_assignment": gt_assign,
            "gt_matches0": gt_matches.astype(np.int32),
            "gt_matches1": gt_matches.astype(np.int32),
        }


def make_sampler(settings: Settings, datasets=None, samples_per_epoch: int = 2000, seed=None,
                 im_sz: int = IM_SZ, K: int = K):
    """The recipe's sample source: the first of `datasets`, or the synthetic
    candidate pairs (each fixed by its index: `seed` is not used)."""
    return (datasets or [SyntheticCandidateDataset(samples_per_epoch, K=K, im_sz=im_sz)])[0]


def make_net(settings: Settings, device="cuda", im_sz: int = IM_SZ):
    """The seeded matching net: ResNet-50 to layer3, 256-channel
    descriptors, ('self', 'cross') x 2 graph layers, 10 Sinkhorn passes,
    keypoints normalised for im_sz x im_sz frames."""
    return target_candidate_matching_net_resnet50(image_shape=(im_sz, im_sz), device=device)


def make_actor(settings: Settings):
    """The recipe's actor, as a function of the net."""
    return TCMActor


def run(settings: Settings, datasets=None, max_epochs: int = 15,
        samples_per_epoch: int = 2000, net=None, device="cuda", im_sz: int = IM_SZ,
        K: int = K):
    device = resolve_device(device)
    settings.description = getattr(settings, "description", None) or \
        "KeepTrack TCM (reference recipe defaults)"
    dataset = make_sampler(settings, datasets, samples_per_epoch, im_sz=im_sz, K=K)
    net = net if net is not None else make_net(settings, device, im_sz)
    return train_recipe(settings, dataset, net, make_actor(settings), BASE_LR, MODULE_LRS,
                        max_epochs, device, freeze_unlisted=FREEZE_UNLISTED,
                        step_size=STEP_SIZE, stack_dim=STACK_DIM)
