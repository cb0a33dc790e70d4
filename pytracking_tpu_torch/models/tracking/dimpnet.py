"""The DiMP network: backbone, meta-learned discriminative classifier and
IoU-Net (counterpart of pytracking_tpu/models/tracking/dimpnet.py:
`DiMPnet`, `dimpnet50`, `dimpnet18`, `klcedimpnet50`, `klcedimpnet18`,
`dimpnet50_simple`).

The tracker calls the parts one by one: `extract_backbone`,
`extract_classification_feat`, `classifier.get_filter` / `classify` /
`filter_optimizer`, and the `bb_regressor` methods on
`get_backbone_bbreg_feat`. Images are (B, 3, H, W) in 0-255. `forward` is
the training forward; the constructors return the net in eval mode, and a
trainer calls `.train()`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from pytracking_tpu_torch.models.backbones import resnet as backbones
from pytracking_tpu_torch.models.bbreg.iou_net import AtomIoUNet
from pytracking_tpu_torch.models.classifier.features import (ResidualBasicBlock,
                                                             ResidualBottleneck)
from pytracking_tpu_torch.models.classifier.initializer import FilterInitializerLinear
from pytracking_tpu_torch.models.classifier.linear_filter import LinearFilter
from pytracking_tpu_torch.models.classifier.optimizer import (DiMPSteepestDescentGN,
                                                              PrDiMPSteepestDescentNewton)
from pytracking_tpu_torch.models.classifier.residual_modules import GNSteepestDescentDiMP
from pytracking_tpu_torch.models.layers.blocks import BatchNorm, trunc_normal_fan_in
from pytracking_tpu_torch.utils.device import resolve_device


class DiMPnet(nn.Module):
    """Classification on layer3, IoU-Net on layer2 and layer3."""

    def __init__(self, feature_extractor: nn.Module, classifier: LinearFilter,
                 bb_regressor: AtomIoUNet):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.classifier = classifier
        self.bb_regressor = bb_regressor

    def extract_backbone(self, im: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.feature_extractor(backbones.normalize_image(im))

    def extract_classification_feat(self, backbone_feat: Dict[str, torch.Tensor]
                                    ) -> torch.Tensor:
        return self.classifier.extract_classification_feat(backbone_feat["layer3"])

    def get_backbone_bbreg_feat(self, backbone_feat: Dict[str, torch.Tensor]):
        return [backbone_feat["layer2"], backbone_feat["layer3"]]

    def forward(self, train_imgs: torch.Tensor, test_imgs: torch.Tensor,
                train_bb: torch.Tensor, test_proposals: torch.Tensor):
        """Training forward: images (N, S, 3, H, W) in 0-255, train boxes
        (Ntrain, S, 4), test proposals (Ntest, S, P, 4) -> the scores of
        every filter iterate (iters, Ntest, S, 1, h, w) and the IoU
        predictions (Ntest, S, P). The backbone runs on the train images,
        then on the test images: in train mode each call moves the
        BatchNorm running statistics, in that order."""
        n_tr, S = train_imgs.shape[:2]
        n_te = test_imgs.shape[0]
        tr_feat = self.extract_backbone(train_imgs.flatten(0, 1))
        te_feat = self.extract_backbone(test_imgs.flatten(0, 1))

        def to_ns(f, n):
            return f.reshape((n, S) + f.shape[1:])

        target_scores, _ = self.classifier(to_ns(tr_feat["layer3"], n_tr),
                                           to_ns(te_feat["layer3"], n_te), train_bb)
        iou_pred = self.bb_regressor([to_ns(tr_feat[k], n_tr) for k in ("layer2", "layer3")],
                                     [to_ns(te_feat[k], n_te) for k in ("layer2", "layer3")],
                                     train_bb, test_proposals)
        return target_scores, iou_pred


@torch.no_grad()
def init_weights(net: DiMPnet, generator: torch.Generator) -> DiMPnet:
    """Random weights drawn from `generator` with the JAX package's
    initialisers: lecun-normal for the convolutions of residual blocks (the
    backbone's and the classification feature's `block{i}`) and for KYS's
    predictor convolutions outside its conv blocks, he-normal for every
    other convolution and dense kernel, zero biases, identity BatchNorm.
    The optimisers' parameters keep their structured initial values."""
    for name, m in net.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun = name.startswith(("feature_extractor.", "classifier.feature_extractor.block")) \
                or (name.startswith("predictor.") and not name.endswith(".Conv_0"))
            trunc_normal_fan_in(m.weight, 1.0 if lecun else 2.0, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return net


FILTER_SIZE = 4


def _dimpnet(backbone: nn.Module, clf_fe: nn.Module, optimizer: nn.Module, out_dim: int,
             iou_input_dim, generator: Optional[torch.Generator], device,
             filter_size: int = FILTER_SIZE) -> DiMPnet:
    """A DiMPnet with a `filter_size` filter (4x4), seeded weights, on
    `device`, in eval mode."""
    device = resolve_device(device)
    classifier = LinearFilter(FilterInitializerLinear(filter_size=filter_size,
                                                      feature_dim=out_dim),
                              optimizer, clf_fe)
    net = DiMPnet(backbone, classifier,
                  AtomIoUNet(input_dim=iou_input_dim, pred_input_dim=(256, 256),
                             pred_inter_dim=(256, 256)))
    init_weights(net, generator or torch.Generator().manual_seed(0))
    return net.to(device).eval()


def _norm_scale(out_dim: int, filter_size: int = FILTER_SIZE) -> float:
    return math.sqrt(1.0 / (out_dim * filter_size * filter_size))


def _dimp_gn(optim_iter: int = 5, optim_init_step: float = 0.9, optim_init_reg: float = 0.1,
             init_gauss_sigma: float = 0.9, num_dist_bins: int = 100,
             bin_displacement: float = 0.1, mask_init_factor: float = 3.0,
             score_act: str = "relu"):
    """DiMP's optimiser: 5 iterations, step 0.9, regulariser 0.1, 100
    distance bins of 0.1 cell, the parametric leaky ReLU on the scores
    (score_act 'relu', the one the port implements)."""
    if score_act != "relu":
        raise ValueError(f"score_act {score_act!r}: the port implements 'relu' only")
    return DiMPSteepestDescentGN(num_iter=optim_iter, feat_stride=16,
                                 init_step_length=optim_init_step,
                                 init_filter_reg=optim_init_reg, init_gauss_sigma=init_gauss_sigma,
                                 num_dist_bins=num_dist_bins, bin_displacement=bin_displacement,
                                 mask_init_factor=mask_init_factor)


def _prdimp_newton(optim_iter: int = 5, gauss_sigma: float = 0.9):
    """PrDiMP's optimiser: 5 iterations, step 1, regulariser 0.05 (also the
    least), label sigma 0.9 cells normalised, alpha_eps 0.05."""
    return PrDiMPSteepestDescentNewton(num_iter=optim_iter, feat_stride=16,
                                       init_step_length=1.0, init_filter_reg=0.05,
                                       min_filter_reg=0.05, gauss_sigma=gauss_sigma,
                                       alpha_eps=0.05, normalize_label=True)


def _r50_features(filter_size: int = FILTER_SIZE):
    return ResidualBottleneck(in_dim=1024, out_dim=512,
                              norm_scale=_norm_scale(512, filter_size))


def _r18_features(filter_size: int = FILTER_SIZE):
    return ResidualBasicBlock(in_dim=256, out_dim=256, norm_scale=_norm_scale(256, filter_size),
                              feature_dim=256, num_blocks=1, final_conv=True)


def dimpnet50(generator: Optional[torch.Generator] = None, device="cuda",
              backbone_dtype: Optional[torch.dtype] = None, filter_size: int = FILTER_SIZE,
              optim_iter: int = 5, optim_init_step: float = 0.9, optim_init_reg: float = 0.1,
              init_gauss_sigma: float = 0.9, num_dist_bins: int = 100,
              bin_displacement: float = 0.1, mask_init_factor: float = 3.0,
              score_act: str = "relu") -> DiMPnet:
    """DiMP-50 on `device`, weights drawn from `generator` (seed 0 when
    none is given): ResNet-50 layer2/layer3 (its convolutions computing in
    `backbone_dtype` when given, its outputs float32), a 3x3 conv
    1024 -> 512 with InstanceL2Norm as the classification feature, a 4x4
    filter and its optimiser (5 iterations by default, step 0.9,
    regulariser 0.1, 100 distance bins of 0.1 cell), IoU-Net on (512, 1024)
    channels with 256-wide heads. The keywords after `backbone_dtype` are
    the training recipes', and their defaults DiMP-50's values; a
    `score_act` other than 'relu' raises ValueError."""
    return _dimpnet(backbones.resnet50(dtype=backbone_dtype), _r50_features(filter_size),
                    _dimp_gn(optim_iter, optim_init_step, optim_init_reg, init_gauss_sigma,
                             num_dist_bins, bin_displacement, mask_init_factor, score_act),
                    512, (512, 1024), generator, device, filter_size)


def dimpnet18(generator: Optional[torch.Generator] = None, device="cuda",
              filter_size: int = FILTER_SIZE, optim_iter: int = 5,
              init_gauss_sigma: float = 0.9, num_dist_bins: int = 100,
              bin_displacement: float = 0.1, mask_init_factor: float = 3.0) -> DiMPnet:
    """DiMP-18: ResNet-18 layer2/layer3, one BasicBlock 256 -> 256 and a 3x3
    conv 256 -> 256 with InstanceL2Norm, DiMP's optimiser, IoU-Net on
    (128, 256) channels. The keywords are the training recipe's."""
    return _dimpnet(backbones.resnet18(), _r18_features(filter_size),
                    _dimp_gn(optim_iter, init_gauss_sigma=init_gauss_sigma,
                             num_dist_bins=num_dist_bins, bin_displacement=bin_displacement,
                             mask_init_factor=mask_init_factor),
                    256, (128, 256), generator, device, filter_size)


def klcedimpnet50(generator: Optional[torch.Generator] = None, device="cuda",
                  filter_size: int = FILTER_SIZE, optim_iter: int = 5,
                  gauss_sigma: float = 0.9) -> DiMPnet:
    """PrDiMP-50: DiMP-50's backbone, feature and IoU-Net with the KL/Newton
    optimiser (its label density's sigma `gauss_sigma` cells)."""
    return _dimpnet(backbones.resnet50(), _r50_features(filter_size),
                    _prdimp_newton(optim_iter, gauss_sigma), 512, (512, 1024), generator,
                    device, filter_size)


def klcedimpnet18(generator: Optional[torch.Generator] = None, device="cuda",
                  filter_size: int = FILTER_SIZE, optim_iter: int = 5,
                  gauss_sigma: float = 0.9) -> DiMPnet:
    """PrDiMP-18: DiMP-18's backbone, feature and IoU-Net with the KL/Newton
    optimiser."""
    return _dimpnet(backbones.resnet18(), _r18_features(filter_size),
                    _prdimp_newton(optim_iter, gauss_sigma), 256, (128, 256), generator,
                    device, filter_size)


def dimpnet50_simple(generator: Optional[torch.Generator] = None, device="cuda",
                     filter_size: int = FILTER_SIZE, optim_iter: int = 5,
                     init_gauss_sigma: float = 0.9) -> DiMPnet:
    """DiMP-50-simple: DiMP-50's net with the generic Gauss-Newton optimiser
    over DiMP's learned residual (5 iterations, regulariser 0.05, the
    bent-identity score activation with parameter 0.05)."""
    optimizer = GNSteepestDescentDiMP(num_iter=optim_iter, feat_stride=16, init_filter_reg=0.05,
                                      init_gauss_sigma=init_gauss_sigma, num_dist_bins=100,
                                      bin_displacement=0.1, mask_init_factor=3.0,
                                      act_param=0.05)
    return _dimpnet(backbones.resnet50(), _r50_features(filter_size), optimizer, 512,
                    (512, 1024), generator, device, filter_size)
