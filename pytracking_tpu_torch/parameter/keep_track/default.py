"""KeepTrack parameters (counterpart of
pytracking_tpu/parameter/keep_track/default.py): SuperDiMP's net (DiMP-50)
at 480x480 'inside_major' samples, search area 8, 10 relative-space box
steps, up to 10 candidates, the certainty-weighted memory; plus the target
candidate matching net (ResNet-50 to layer3, SuperGlue with ('self',
'cross') x 2 and 10 Sinkhorn passes) as the tracker's `tcm_net`. The nets
are the network files `super_dimp_simple` (whose sidecar builds the
DiMP-50-simple net, as the JAX module's does) and `keep_track_tcm` where
they exist; else, as no checkpoint is in the repository, they are drawn
from seeded torch.Generators."""

import torch

from pytracking_tpu_torch.models.tcm.target_candidate_matching import \
    target_candidate_matching_net_resnet50
from pytracking_tpu_torch.models.tracking.dimpnet import dimpnet50
from pytracking_tpu_torch.parameter.networks import load_or_seeded
from pytracking_tpu_torch.trackers.base import TrackerSpec
from pytracking_tpu_torch.trackers.keep_track import KeepTrackParams


def params() -> KeepTrackParams:
    return KeepTrackParams()               # its defaults are the module's


def parameters(device="cuda", seed: int = 0) -> TrackerSpec:
    """DiMP-50 from seed `seed`, the matching net from `seed + 1`; the
    matcher normalises keypoints by the module's sample size."""
    p = params()
    net = load_or_seeded("super_dimp_simple", lambda: dimpnet50(
        generator=torch.Generator().manual_seed(seed), device=device), device)
    s = p.image_sample_size
    tcm_net = load_or_seeded("keep_track_tcm", lambda: target_candidate_matching_net_resnet50(
        generator=torch.Generator().manual_seed(seed + 1), device=device, image_shape=(s, s)),
        device)
    return TrackerSpec(params=p, net=net, tracker_kwargs={"tcm_net": tcm_net})
