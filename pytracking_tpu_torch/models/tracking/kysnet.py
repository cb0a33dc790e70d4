"""The KYS network: DiMP's appearance model plus the scene-propagation
branch (counterpart of pytracking_tpu/models/tracking/kysnet.py `KYSNet`,
`kysnet_res50`)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from pytracking_tpu_torch.models.backbones import resnet as backbones
from pytracking_tpu_torch.models.bbreg.iou_net import AtomIoUNet
from pytracking_tpu_torch.models.classifier.initializer import FilterInitializerLinear
from pytracking_tpu_torch.models.classifier.linear_filter import LinearFilter
from pytracking_tpu_torch.models.kys.cost_volume import cost_volume_abs
from pytracking_tpu_torch.models.kys.response_predictor import (ResponsePredictor,
                                                                shift_features)
from pytracking_tpu_torch.models.tracking.dimpnet import (FILTER_SIZE, DiMPnet, _dimp_gn,
                                                          _r50_features, init_weights)
from pytracking_tpu_torch.utils.device import resolve_device


class KYSNet(DiMPnet):
    """DiMPnet with the motion branch: a cost volume between the previous
    and the current frame's motion features drives the response
    predictor."""

    def __init__(self, feature_extractor: nn.Module, classifier: LinearFilter,
                 bb_regressor: AtomIoUNet, predictor: ResponsePredictor,
                 max_displacement: int = 9, cv_kernel_size: int = 3):
        super().__init__(feature_extractor, classifier, bb_regressor)
        self.predictor = predictor
        self.max_displacement = max_displacement
        self.cv_kernel_size = cv_kernel_size

    def get_motion_feat(self, backbone_feat: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The motion features are the raw layer3 map (1024 channels for
        ResNet-50), not the projected classification feature."""
        return backbone_feat["layer3"]

    def predict_response(self, motion_feat_prev, motion_feat_cur, state_prev, dimp_score_cur,
                         init_label=None, dimp_thresh=None, output_window=None,
                         state_valid=None, aux: bool = False):
        """Inputs (B, C, H, W); returns (fused (B, 1, H, W), state (B, D, H,
        W), aux dict). The DiMP score and the label are shifted by a quarter
        cell before the predictor and the response back after it."""
        cv = cost_volume_abs(motion_feat_cur, motion_feat_prev, self.max_displacement,
                             kernel_size=self.cv_kernel_size)
        B, _, H, W = dimp_score_cur.shape
        # filled on the device: a host tensor copied up would synchronise
        dev = dimp_score_cur.device
        s_pre = torch.stack([torch.full((B,), 0.25 / H, device=dev),
                             torch.full((B,), 0.25 / W, device=dev)], dim=1)
        dimp_in = shift_features(dimp_score_cur, s_pre)
        label_in = shift_features(init_label, s_pre) if init_label is not None else None
        fused, state_new, out_aux = self.predictor(
            cv, state_prev, dimp_in, init_label=label_in, dimp_thresh=dimp_thresh,
            output_window=output_window, state_valid=state_valid, aux=aux)
        return shift_features(fused, -s_pre), state_new, out_aux


def kysnet_res50(generator: Optional[torch.Generator] = None, device="cuda",
                 state_dim: int = 8, representation_predictor_dims: Sequence[int] = (64, 32),
                 conf_measure: str = "entropy", dimp_thresh: float = 0.05,
                 max_displacement: int = 9, optim_iter: int = 5) -> KYSNet:
    """KYS on `device`, weights drawn from `generator` (seed 0 when none is
    given): DiMP-50's backbone, classifier (`optim_iter` steepest-descent
    steps: 5 when tracking, 3 in the training recipe) and IoU-Net, and a
    response predictor with an 8-channel state, (64, 32) representation
    convs, the entropy confidence, a DiMP-score threshold of 0.05 and
    displacements up to 9 cells."""
    device = resolve_device(device)
    classifier = LinearFilter(FilterInitializerLinear(filter_size=FILTER_SIZE, feature_dim=512),
                              _dimp_gn(optim_iter), _r50_features())
    predictor = ResponsePredictor(state_dim=state_dim,
                                  representation_predictor_dims=representation_predictor_dims,
                                  conf_measure=conf_measure, dimp_thresh=dimp_thresh)
    net = KYSNet(backbones.resnet50(), classifier,
                 AtomIoUNet(input_dim=(512, 1024), pred_input_dim=(256, 256),
                            pred_inter_dim=(256, 256)),
                 predictor, max_displacement=max_displacement)
    init_weights(net, generator or torch.Generator().manual_seed(0))
    return net.to(device).eval()
