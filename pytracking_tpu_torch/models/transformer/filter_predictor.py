"""Transformer filter predictor of ToMP and the box encoder it shares with
TaMOs (counterpart of pytracking_tpu/models/transformer/filter_predictor.py:
`BoxEncoder`, `FilterPredictor`).

Shapes: features (Nf, Ns, C, H, W); labels (Nf, Ns, H, W); ltrb maps
(Nf, Ns, H, W, 4); frame masks (Nf,) bool, or (Nf, Ns): one per sequence
(the batched server's streams). Token order is (frame, row, col),
channels last, as in the JAX package. The filter is (Ns, C), one per
sequence.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pytracking_tpu_torch.models.layers.blocks import BatchNorm
from pytracking_tpu_torch.models.transformer.position_encoding import \
    position_embedding_sine
from pytracking_tpu_torch.models.transformer.transformer import Transformer


def _tokens(feat: torch.Tensor) -> torch.Tensor:
    """(Nf, Ns, C, H, W) -> (Ns, Nf*H*W, C)."""
    Nf, Ns, C, H, W = feat.shape
    return feat.permute(1, 0, 3, 4, 2).reshape(Ns, Nf * H * W, C)


def _stack2(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    return torch.cat([x, x], dim=dim)


def _pos_tokens(feat: torch.Tensor, feature_sz: int) -> torch.Tensor:
    """Sine position tokens of a (Nf, Ns, C, H, W) stack: (Ns, Nf*H*W, C)."""
    Nf, Ns, C, H, W = feat.shape
    pos = position_embedding_sine((H, W), C, feature_sz, device=feat.device)
    return pos.reshape(1, H * W, C).repeat(Ns, Nf, 1)


def _frame_key_padding(frame_mask: torch.Tensor, train_hw: int, test_len: int
                       ) -> torch.Tensor:
    """(Nf,) frames to keep -> (Nf*train_hw + test_len,) tokens to ignore, or
    (Nf, Ns) frames to keep per sequence -> (Ns, Nf*train_hw + test_len); the
    test tokens are always kept."""
    ignore = torch.repeat_interleave(~frame_mask.bool(), train_hw, dim=0).movedim(0, -1)
    return torch.cat([ignore, ignore.new_zeros(ignore.shape[:-1] + (test_len,))], dim=-1)


class BoxEncoder(nn.Module):
    """Tokenwise MLP 4 -> d/4 -> d -> d with BatchNorm + ReLU between layers,
    on (..., 4). In train mode the BatchNorms normalise over every token of
    the batch and move their running statistics, as flax's do."""

    def __init__(self, d_model: int):
        super().__init__()
        dims = [4, d_model // 4, d_model, d_model]
        self.lin0 = nn.Linear(dims[0], dims[1])
        self.bn0 = BatchNorm(dims[1], dim=-1)
        self.lin1 = nn.Linear(dims[1], dims[2])
        self.bn1 = BatchNorm(dims[2], dim=-1)
        self.lin2 = nn.Linear(dims[2], dims[3])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn0(self.lin0(x)))
        x = F.relu(self.bn1(self.lin1(x)))
        return self.lin2(x)


class FilterPredictor(nn.Module):
    """ToMP's model predictor: train tokens carry the foreground token times
    the Gaussian label plus the box encoding of the dense LTRB map, test
    tokens the test-frame token; the single decoder query is the foreground
    token and its output is the filter. `generator` draws the transformer's
    dropout masks in train mode."""

    def __init__(self, transformer: Transformer, feature_sz: int = 18,
                 use_test_frame_encoding: bool = True):
        super().__init__()
        d = transformer.d_model
        self.transformer = transformer
        self.feature_sz = feature_sz
        self.box_encoding = BoxEncoder(d)
        self.query_embed_fg = nn.Parameter(torch.empty(1, d))
        nn.init.normal_(self.query_embed_fg)
        if use_test_frame_encoding:
            self.query_embed_test = nn.Parameter(torch.empty(1, d))
            nn.init.normal_(self.query_embed_test)
        else:
            self.register_parameter("query_embed_test", None)

    def _build_sequence(self, train_feat, test_feat, train_label, train_ltrb):
        Nf, Ns = train_label.shape[:2]
        label_tok = train_label.transpose(0, 1).reshape(Ns, -1)
        ltrb_tok = train_ltrb.transpose(0, 1).reshape(Ns, -1, 4)
        train_tok = _tokens(train_feat) + self.query_embed_fg * label_tok[..., None] \
            + self.box_encoding(ltrb_tok)
        test_tok = _tokens(test_feat)
        if self.query_embed_test is not None:
            test_tok = test_tok + self.query_embed_test
        seq = torch.cat([train_tok, test_tok], dim=1)
        pos = torch.cat([_pos_tokens(train_feat, self.feature_sz),
                         _pos_tokens(test_feat, self.feature_sz)], dim=1)
        return seq, pos

    def _decode(self, seq, pos, key_padding, test_feat, generator=None):
        """-> (filters (B, C), enhanced test feature (Nf_te, B, C, h, w)), B
        the sequence batch."""
        Nf_te, _, C, h, w = test_feat.shape
        dec, mem = self.transformer(seq, self.query_embed_fg, pos,
                                    key_padding_mask=key_padding, generator=generator)
        enc = mem[:, -Nf_te * h * w:].reshape(seq.shape[0], Nf_te, h, w, C)
        return dec[:, 0], enc.permute(1, 0, 4, 2, 3)

    def forward(self, train_feat, test_feat, train_label, train_ltrb, generator=None):
        return self.predict_filter(train_feat, test_feat, train_label, train_ltrb, generator)

    def predict_filter(self, train_feat, test_feat, train_label, train_ltrb, generator=None):
        """Returns (filter (Ns, C), enhanced test feature (Nf_te, Ns, C, h, w))."""
        seq, pos = self._build_sequence(train_feat, test_feat, train_label, train_ltrb)
        return self._decode(seq, pos, None, test_feat, generator)

    def predict_cls_bbreg_filters_parallel(self, train_feat, test_feat, train_label,
                                           train_ltrb, cls_frame_mask=None,
                                           bbreg_frame_mask=None):
        """One forward over the sequence batch duplicated: copy 0 ignores the
        train frames outside `cls_frame_mask` (the classification filter),
        copy 1 those outside `bbreg_frame_mask` (the box regression filter).
        A mask of None keeps every frame; a mask is (Nf,) or (Nf, Ns).

        Returns (cls_filter, bbreg_filter, cls_enc, bbreg_enc): filters
        (Ns, C), enc (Nf_te, Ns, C, h, w)."""
        Nf, Ns, C, H, W = train_feat.shape
        Nf_te, _, _, h, w = test_feat.shape
        seq, pos = self._build_sequence(_stack2(train_feat), _stack2(test_feat),
                                        _stack2(train_label), _stack2(train_ltrb))
        rows = []
        for fmask in (cls_frame_mask, bbreg_frame_mask):
            if fmask is None:
                fmask = torch.ones(Nf, dtype=torch.bool, device=seq.device)
            rows.append(_frame_key_padding(fmask, H * W, Nf_te * h * w).expand(Ns, -1))
        dec, enc = self._decode(seq, pos, torch.cat(rows, dim=0), test_feat)
        return dec[:Ns], dec[Ns:], enc[:, :Ns], enc[:, Ns:]
