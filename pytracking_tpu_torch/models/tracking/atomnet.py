"""The ATOM network: a ResNet backbone and the IoU-Net; the classifier is
learned online by the tracker (counterpart of
pytracking_tpu/models/tracking/atomnet.py: `ATOMnet`, `atom_resnet18`,
`atom_resnet50`).

The tracker calls `extract_backbone` and the IoU-Net's methods on
`get_backbone_bbreg_feat`; the online classifier reads layer3. Images are
(B, 3, H, W) in 0-255. `forward` is the training forward (IoU predictions
only).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from pytracking_tpu_torch.models.backbones import resnet as backbones
from pytracking_tpu_torch.models.bbreg.iou_net import AtomIoUNet
from pytracking_tpu_torch.models.tracking.dimpnet import init_weights
from pytracking_tpu_torch.utils.device import resolve_device


class ATOMnet(nn.Module):
    """IoU-Net on layer2 and layer3 of the backbone."""

    def __init__(self, feature_extractor: nn.Module, bb_regressor: AtomIoUNet):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.bb_regressor = bb_regressor

    def extract_backbone(self, im: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.feature_extractor(backbones.normalize_image(im))

    def get_backbone_bbreg_feat(self, backbone_feat: Dict[str, torch.Tensor]):
        return [backbone_feat["layer2"], backbone_feat["layer3"]]

    def forward(self, train_imgs: torch.Tensor, test_imgs: torch.Tensor,
                train_bb: torch.Tensor, test_proposals: torch.Tensor) -> torch.Tensor:
        """Training forward: images (N, S, 3, H, W) in 0-255, train boxes
        (Ntrain, S, 4), test proposals (Ntest, S, P, 4) -> the IoU
        predictions (Ntest, S, P). The backbone runs on the train images,
        then on the test images (in train mode each call moves the
        BatchNorm running statistics, in that order)."""
        n_tr, S = train_imgs.shape[:2]
        n_te = test_imgs.shape[0]
        tr_feat = self.extract_backbone(train_imgs.flatten(0, 1))
        te_feat = self.extract_backbone(test_imgs.flatten(0, 1))
        return self.bb_regressor(
            [tr_feat[k].reshape((n_tr, S) + tr_feat[k].shape[1:]) for k in ("layer2", "layer3")],
            [te_feat[k].reshape((n_te, S) + te_feat[k].shape[1:]) for k in ("layer2", "layer3")],
            train_bb, test_proposals)


def _atomnet(backbone: nn.Module, input_dim, iou_input_dim, iou_inter_dim,
             generator: Optional[torch.Generator], device) -> ATOMnet:
    device = resolve_device(device)
    net = ATOMnet(backbone, AtomIoUNet(input_dim=input_dim, pred_input_dim=tuple(iou_input_dim),
                                       pred_inter_dim=tuple(iou_inter_dim)))
    init_weights(net, generator or torch.Generator().manual_seed(0))
    return net.to(device).eval()


def atom_resnet18(iou_input_dim=(256, 256), iou_inter_dim=(256, 256),
                  generator: Optional[torch.Generator] = None, device="cuda") -> ATOMnet:
    """ATOM: ResNet-18 layer2/layer3, IoU-Net on (128, 256) channels, weights
    drawn from `generator` (seed 0 when none is given) with the JAX
    package's initialisers."""
    return _atomnet(backbones.resnet18(), (128, 256), iou_input_dim, iou_inter_dim,
                    generator, device)


def atom_resnet50(iou_input_dim=(256, 256), iou_inter_dim=(256, 256),
                  generator: Optional[torch.Generator] = None, device="cuda") -> ATOMnet:
    """ATOM on ResNet-50 layer2/layer3, IoU-Net on (512, 1024) channels."""
    return _atomnet(backbones.resnet50(), (512, 1024), iou_input_dim, iou_inter_dim,
                    generator, device)
