"""Target candidate matching network of KeepTrack (counterpart of
pytracking_tpu/models/tcm/target_candidate_matching.py `DescriptorExtractor`,
`TargetCandidateMatchingNetwork`, `target_candidate_matching_net_resnet50`):
a ResNet-50 of its own to layer3, a descriptor conv sampled at the
candidates, and the SuperGlue matcher. The tracker calls the parts;
`forward` is the training forward."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from pytracking_tpu_torch.models.backbones import resnet as backbones
from pytracking_tpu_torch.models.layers.blocks import BatchNorm, trunc_normal_fan_in
from pytracking_tpu_torch.models.tcm.superglue import SuperGlueMatcher
from pytracking_tpu_torch.utils.device import resolve_device


class DescriptorExtractor(nn.Module):
    """A conv over the backbone feature, read at the candidates' cells. The
    4x4 kernel with padding 2 makes the map one cell larger than its
    input."""

    def __init__(self, in_dim: int, descriptor_dim: int = 256, kernel_size: int = 4):
        super().__init__()
        self.descriptor_dim = descriptor_dim
        self.conv = nn.Conv2d(in_dim, descriptor_dim, kernel_size, padding=kernel_size // 2)

    def forward(self, feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """feat (B, C, H, W); coords (B, K, 2) integer (row, col) cells,
        clipped to the conv's output. Returns (B, K, descriptor_dim)."""
        f = self.conv(feat)
        Ho, Wo = f.shape[-2], f.shape[-1]
        r = torch.clamp(coords[..., 0].long(), 0, Ho - 1)
        c = torch.clamp(coords[..., 1].long(), 0, Wo - 1)
        flat = (r * Wo + c)[:, None, :].expand(-1, f.shape[1], -1)          # (B, D, K)
        return torch.gather(f.flatten(2), 2, flat).transpose(1, 2)


class TargetCandidateMatchingNetwork(nn.Module):
    def __init__(self, feature_extractor: nn.Module, descriptor_extractor: DescriptorExtractor,
                 matcher: SuperGlueMatcher, classification_layer: str = "layer3"):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.descriptor_extractor = descriptor_extractor
        self.matcher = matcher
        self.classification_layer = classification_layer

    def extract_backbone(self, im: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.feature_extractor(backbones.normalize_image(im))

    def get_descriptors(self, backbone_feat: Dict[str, torch.Tensor],
                        coords: torch.Tensor) -> torch.Tensor:
        return self.descriptor_extractor(backbone_feat[self.classification_layer], coords)

    def match(self, img_coords0, img_coords1, desc0, desc1, scores0, scores1, valid0=None,
              valid1=None) -> dict:
        return self.matcher(img_coords0, img_coords1, desc0, desc1, scores0, scores1,
                            valid0=valid0, valid1=valid1)

    def forward(self, img0, img1, tsm_coords0, tsm_coords1, img_coords0, img_coords1,
                scores0, scores1) -> dict:
        """The training forward: the frames img0, img1 (S, 3, H, W) in 0-255
        through the backbone in two calls, the descriptors at the cells
        tsm_coords0/1 (S, K, 2), and the matcher on them with the candidates'
        image coordinates img_coords0/1 (S, K, 2) and scores0/1 (S, K). In
        train mode the BatchNorms move their running statistics on each
        call: the backbone's on img0 then img1, the keypoint encoder's on
        frame 0's candidates then frame 1's, each graph layer's on set 0
        then set 1."""
        f0 = self.extract_backbone(img0.reshape((-1,) + img0.shape[-3:]))
        f1 = self.extract_backbone(img1.reshape((-1,) + img1.shape[-3:]))
        return self.matcher(img_coords0, img_coords1, self.get_descriptors(f0, tsm_coords0),
                            self.get_descriptors(f1, tsm_coords1), scores0, scores1)


@torch.no_grad()
def init_weights(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn from `generator` with flax's default
    initialiser (lecun-normal kernels, zero biases), identity BatchNorm and
    a dustbin score of 1."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            trunc_normal_fan_in(m.weight, 1.0, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return net


def target_candidate_matching_net_resnet50(
        generator: Optional[torch.Generator] = None, device="cuda", num_gnn_layers: int = 2,
        num_sinkhorn_iterations: int = 10,
        image_shape: Tuple[int, int] = (352, 352)) -> TargetCandidateMatchingNetwork:
    """KeepTrack's matching net on `device`, weights drawn from `generator`
    (seed 0 when none is given): ResNet-50 to layer3, 256-channel
    descriptors, a graph net of ('self', 'cross') x `num_gnn_layers`, and
    `num_sinkhorn_iterations` Sinkhorn passes."""
    device = resolve_device(device)
    net = TargetCandidateMatchingNetwork(
        backbones.resnet50(output_layers=("layer3",)),
        DescriptorExtractor(1024, descriptor_dim=256, kernel_size=4),
        SuperGlueMatcher(input_dim=256, descriptor_dim=256, num_gnn_layers=num_gnn_layers,
                         num_sinkhorn_iterations=num_sinkhorn_iterations,
                         image_shape=tuple(image_shape)))
    init_weights(net, generator or torch.Generator().manual_seed(0))
    return net.to(device).eval()
