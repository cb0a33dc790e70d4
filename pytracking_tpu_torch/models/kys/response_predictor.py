"""KYS response predictor (counterpart of
pytracking_tpu/models/kys/response_predictor.py `shift_features`,
`ResponsePredictor`): propagate the scene state with the cost volume and
fuse it with the appearance model's (DiMP's) score.

The propagation sum over the previous positions, w(prev, cur) ·
state(prev), is one batched (D, HW) x (HW, HW) product.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pytracking_tpu_torch.models.kys.conv_gru import ConvGRUCell
from pytracking_tpu_torch.models.layers.blocks import ConvBlock


def shift_features(feat: torch.Tensor, shift_yx: torch.Tensor) -> torch.Tensor:
    """Bilinear sub-pixel shift of feat (B, C, H, W) by shift_yx (B, 2),
    (y, x) in units of the map's size: a positive shift moves the content
    by +s·size cells, towards higher indices. The four taps of each output
    cell are gathered explicitly; a tap outside the map contributes zero."""
    B, C, H, W = feat.shape
    s = shift_yx.reshape(B, 2).float()
    featp = F.pad(feat, (1, 1, 1, 1))
    yy = torch.arange(H, dtype=torch.float32, device=feat.device)[None, :] - s[:, 0:1] * H
    xx = torch.arange(W, dtype=torch.float32, device=feat.device)[None, :] - s[:, 1:2] * W
    y0 = torch.floor(yy)                                              # (B, H)
    x0 = torch.floor(xx)                                              # (B, W)
    wy = yy - y0
    wx = xx - x0
    b = torch.arange(B, device=feat.device)[:, None, None]
    out = 0.0
    for dy in (0, 1):
        yi = y0 + dy
        for dx in (0, 1):
            xi = x0 + dx
            valid = (((yi >= 0) & (yi <= H - 1))[:, :, None]
                     & ((xi >= 0) & (xi <= W - 1))[:, None, :])
            w = ((wy if dy else 1 - wy)[:, :, None] * (wx if dx else 1 - wx)[:, None, :]
                 * valid)                                             # (B, H, W)
            yi_c = torch.clamp(yi + 1, 0, H + 1).long()[:, :, None]
            xi_c = torch.clamp(xi + 1, 0, W + 1).long()[:, None, :]
            tap = featp[b, :, yi_c, xi_c]                             # (B, H, W, C)
            out = out + w[:, None] * tap.permute(0, 3, 1, 2)
    return out


class ResponsePredictor(nn.Module):
    """Cost-volume processing, state propagation, response fusion and the
    GRU state update. `is_target_0/1` is one head applied to several states
    (the auxiliary outputs)."""

    def __init__(self, state_dim: int = 8, representation_predictor_dims: Sequence[int] = (64, 32),
                 gru_ksz: int = 3, conf_measure: str = "max",
                 dimp_thresh: Optional[float] = None):
        super().__init__()
        self.state_dim = state_dim
        self.conf_measure = conf_measure
        self.dimp_thresh = dimp_thresh
        pad = gru_ksz // 2
        self.is_target_0 = nn.Conv2d(state_dim, 4, gru_ksz, padding=pad)
        self.is_target_1 = nn.Conv2d(4, 1, gru_ksz, padding=pad)
        self.cvproc1_0 = ConvBlock(1, 8, 3)
        self.cvproc1_1 = ConvBlock(8, 1, 3, relu=False)
        self.cvproc2_0 = ConvBlock(1, 8, 3)
        self.cvproc2_1 = ConvBlock(8, 1, 3, relu=False)
        self.init_hidden = nn.Conv2d(1, state_dim, 3, padding=1, bias=False)
        in_dim = state_dim + 1 + (1 if conf_measure in ("max", "entropy") else 0)
        self.repr_names = []
        for i, d in enumerate(representation_predictor_dims):
            self.add_module(f"repr{i}", ConvBlock(in_dim, d, 3, batch_norm=False))
            self.repr_names.append(f"repr{i}")
            in_dim = d
        self.response_pred = nn.Conv2d(in_dim, 1, 3, padding=1)
        self.state_predictor = ConvGRUCell(4, state_dim, gru_ksz)

    def is_target(self, state: torch.Tensor) -> torch.Tensor:
        return self.is_target_1(F.relu(self.is_target_0(state)))

    def forward(self, cost_volume: torch.Tensor, state_prev: Optional[torch.Tensor],
                dimp_score_cur: torch.Tensor, init_label: Optional[torch.Tensor] = None,
                dimp_thresh: Optional[float] = None, output_window: Optional[torch.Tensor] = None,
                state_valid: Optional[torch.Tensor] = None, aux: bool = False):
        """cost_volume (B, HW, H, W); state_prev (B, D, H, W) or None;
        dimp_score_cur (B, 1, H, W); init_label (B, 1, H, W), which seeds the
        state when state_prev is None. `state_valid`, a () bool on the
        device, selects between state_prev and the label-seeded state.

        Returns (fused response (B, 1, H, W), new state (B, D, H, W), a dict
        of the auxiliary outputs, empty unless `aux`)."""
        if dimp_thresh is None:
            dimp_thresh = self.dimp_thresh
        B, HW, H, W = cost_volume.shape
        out_aux = {}

        cv = self.cvproc1_1(self.cvproc1_0(cost_volume.reshape(-1, 1, H, W)))
        cv = torch.softmax(cv.reshape(-1, H * W), dim=1)               # over current positions
        cv = self.cvproc2_1(self.cvproc2_0(cv.reshape(-1, 1, H, W)))
        w_prop = torch.softmax(cv.reshape(B, HW, H * W), dim=1)        # over previous positions

        if state_prev is None or (state_valid is not None and init_label is not None):
            init_state = torch.tanh(self.init_hidden(init_label))
            state_prev = init_state if state_prev is None else \
                torch.where(state_valid, state_prev, init_state)
        if aux:
            out_aux["is_target"] = self.is_target(state_prev)

        # (B, D, HW_prev) x (B, HW_prev, HW_cur)
        propagated = torch.bmm(state_prev.reshape(B, self.state_dim, HW), w_prop)
        propagated = propagated.reshape(B, self.state_dim, H, W)
        if aux:
            out_aux["is_target_after_prop"] = self.is_target(propagated)

        if self.conf_measure == "max":
            conf = w_prop.amax(dim=1).reshape(B, 1, H, W)
        elif self.conf_measure == "entropy":
            conf = -(w_prop * torch.log(w_prop + 1e-4)).sum(dim=1).reshape(B, 1, H, W)
        else:
            conf = None
        if aux:
            out_aux["propagation_conf"] = conf

        x = torch.cat([propagated, dimp_score_cur] + ([conf] if conf is not None else []), dim=1)
        for name in self.repr_names:
            x = getattr(self, name)(x)
        fused = torch.sigmoid(self.response_pred(x))
        if aux:
            out_aux["fused_score_orig"] = fused
        if dimp_thresh is not None:
            fused = fused * (dimp_score_cur > dimp_thresh)
        if output_window is not None:
            fused = fused * output_window

        scores_cat = torch.cat([dimp_score_cur, fused], dim=1)
        pooled = scores_cat.amax(dim=(2, 3), keepdim=True).expand_as(scores_cat)
        state_new = self.state_predictor(torch.cat([scores_cat, pooled], dim=1), propagated)
        if aux:
            out_aux["is_target_new"] = self.is_target(state_new)
        return fused, state_new, out_aux
