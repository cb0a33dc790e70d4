"""ATOM IoU-Net, the modulation-based IoU predictor of DiMP's box refinement
(counterpart of pytracking_tpu/models/bbreg/iou_net.py `AtomIoUNet`: the
tracking-time methods and the training forward).

Two backbone layers (stride 8 and 16) give the reference branch's
modulation vectors and the test branch's IoU features; `predict_iou`
pools the proposals with precise RoI pooling at both scales and regresses
their IoU. It is differentiable in the proposals, which the tracker's
gradient ascent uses. Maps are NCHW; boxes (x, y, w, h) in image-patch
coordinates.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from pytracking_tpu_torch.models.layers.blocks import ConvBlock, LinearBlock
from pytracking_tpu_torch.ops.prroi_pool import prroi_pool2d


def _xywh_to_xyxy(bb: torch.Tensor) -> torch.Tensor:
    return torch.cat([bb[..., :2], bb[..., :2] + bb[..., 2:4]], dim=-1)


class AtomIoUNet(nn.Module):
    def __init__(self, input_dim: Tuple[int, int] = (512, 1024),
                 pred_input_dim: Tuple[int, int] = (256, 256),
                 pred_inter_dim: Tuple[int, int] = (256, 256)):
        super().__init__()
        self.conv3_1r = ConvBlock(input_dim[0], 128, 3)
        self.conv3_1t = ConvBlock(input_dim[0], 256, 3)
        self.conv3_2t = ConvBlock(256, pred_input_dim[0], 3)
        self.fc3_1r = ConvBlock(128, 256, 3, padding=0)
        self.conv4_1r = ConvBlock(input_dim[1], 256, 3)
        self.conv4_1t = ConvBlock(input_dim[1], 256, 3)
        self.conv4_2t = ConvBlock(256, pred_input_dim[1], 3)
        self.fc34_3r = ConvBlock(512, pred_input_dim[0], 1, padding=0)
        self.fc34_4r = ConvBlock(512, pred_input_dim[1], 1, padding=0)
        self.fc3_rt = LinearBlock(pred_input_dim[0] * 5 * 5, pred_inter_dim[0])
        self.fc4_rt = LinearBlock(pred_input_dim[1] * 3 * 3, pred_inter_dim[1])
        self.iou_predictor = nn.Linear(pred_inter_dim[0] + pred_inter_dim[1], 1)

    def get_modulation(self, feat: Sequence[torch.Tensor], bb: torch.Tensor):
        """Modulation vectors from the reference frame's [layer2, layer3]
        features and its target box bb (B, 4): two (B, D) tensors."""
        feat3_r, feat4_r = feat
        B = bb.shape[0]
        rois = _xywh_to_xyxy(bb.reshape(-1, 4).to(torch.float32))
        bidx = torch.arange(B, device=bb.device)
        roi3r = prroi_pool2d(self.conv3_1r(feat3_r), rois, bidx, (3, 3), 1 / 8)
        roi4r = prroi_pool2d(self.conv4_1r(feat4_r), rois, bidx, (1, 1), 1 / 16)
        fc34_r = torch.cat([self.fc3_1r(roi3r), roi4r], dim=1)    # (B, 512, 1, 1)
        return self.fc34_3r(fc34_r).reshape(B, -1), self.fc34_4r(fc34_r).reshape(B, -1)

    def get_iou_feat(self, feat: Sequence[torch.Tensor]):
        """Test-branch IoU features from [layer2, layer3]."""
        feat3_t, feat4_t = feat
        return (self.conv3_2t(self.conv3_1t(feat3_t)),
                self.conv4_2t(self.conv4_1t(feat4_t)))

    def predict_iou(self, modulation, feat, proposals: torch.Tensor) -> torch.Tensor:
        """IoU of each proposal: modulation two (B, D), feat two (B, D, H, W),
        proposals (B, P, 4) -> (B, P)."""
        fc34_3_r, fc34_4_r = modulation
        c3_t, c4_t = feat
        B, P = proposals.shape[:2]
        rois = _xywh_to_xyxy(proposals.reshape(-1, 4).to(torch.float32))
        bidx = torch.arange(B * P, device=proposals.device) // P
        roi3t = prroi_pool2d(c3_t * fc34_3_r[:, :, None, None], rois, bidx, (5, 5), 1 / 8)
        roi4t = prroi_pool2d(c4_t * fc34_4_r[:, :, None, None], rois, bidx, (3, 3), 1 / 16)
        fc34_rt = torch.cat([self.fc3_rt(roi3t), self.fc4_rt(roi4t)], dim=-1)
        return self.iou_predictor(fc34_rt).reshape(B, P)

    def forward(self, feat1: Sequence[torch.Tensor], feat2: Sequence[torch.Tensor],
                bb1: torch.Tensor, proposals2: torch.Tensor) -> torch.Tensor:
        """Training forward: [layer2, layer3] features (N, S, C, H, W) of the
        train (feat1) and test (feat2) frames, train boxes bb1 (Ntrain, S, 4)
        and test proposals (N, S, P, 4) -> (N, S, P). The modulation comes
        from the first train frame alone and serves every test frame."""
        N, S, P = proposals2.shape[:3]
        modulation = self.get_modulation([f[0] for f in feat1], bb1[0])
        iou_feat = self.get_iou_feat([f.flatten(0, 1) for f in feat2])
        modulation = [m.repeat(N, 1) for m in modulation]          # row n*S + s is m[s]
        return self.predict_iou(modulation, iou_feat,
                                proposals2.reshape(N * S, P, 4)).reshape(N, S, P)
