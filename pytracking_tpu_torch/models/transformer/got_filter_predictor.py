"""Multi-object (GOT) transformer filter predictor of TaMOs (counterpart of
pytracking_tpu/models/transformer/got_filter_predictor.py).

K learned object queries; each object's Gaussian label is injected into the
train tokens as sum_k fg_token[k] * label_k (and, with box_enc='ltrb_token',
its box encoding weighted by the same token); the decoder emits one filter
per object in one forward.

Shapes: features (Nf, Ns, C, H, W); labels (Nf, Ns, K, H, W); ltrb maps
(Nf, Ns, K, H, W, 4); frame masks (Nf,) bool, or (Nf, Ns): one per sequence
(the batched server's streams). Filters are (Ns, K, C). Token
order is (frame, row, col), as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from pytracking_tpu_torch.models.transformer.filter_predictor import (
    BoxEncoder, _frame_key_padding, _pos_tokens, _stack2, _tokens)
from pytracking_tpu_torch.models.transformer.transformer import Transformer


class GOTFilterPredictor(nn.Module):
    def __init__(self, transformer: Transformer, feature_sz: int = 24,
                 num_tokens: int = 10, box_enc: str = "ltrb"):
        super().__init__()
        d = transformer.d_model
        self.transformer = transformer
        self.feature_sz = feature_sz
        self.num_tokens = num_tokens
        self.box_enc = box_enc
        self.box_encoding = BoxEncoder(d)
        self.query_embed_fg = nn.Parameter(torch.empty(num_tokens, d))
        nn.init.orthogonal_(self.query_embed_fg)

    def _pos(self, feat: torch.Tensor) -> torch.Tensor:
        return _pos_tokens(feat, self.feature_sz)

    def _train_tokens(self, train_feat, train_label, train_ltrb):
        Nf, Ns, C, H, W = train_feat.shape
        K = self.num_tokens
        fg = self.query_embed_fg
        tok = _tokens(train_feat)
        label_tok = train_label.permute(1, 0, 3, 4, 2).reshape(Ns, Nf * H * W, K)
        tok = tok + torch.einsum("blk,kc->blc", label_tok, fg)
        if self.box_enc == "ltrb_token" and train_ltrb is not None:
            ltrb_tok = train_ltrb.permute(1, 0, 3, 4, 2, 5).reshape(Ns, Nf * H * W, K, 4)
            tok = tok + torch.einsum("blkc,kc->blc", self.box_encoding(ltrb_tok), fg)
        return tok

    def _decode(self, seq, pos, key_padding, test_feat, generator=None):
        """-> (filters (B, K, C), enhanced test feature (Nf_te, B, C, h, w)),
        B the sequence batch."""
        Nf_te, _, C, h, w = test_feat.shape
        dec, mem = self.transformer(seq, self.query_embed_fg, pos,
                                    key_padding_mask=key_padding, generator=generator)
        enc = mem[:, -Nf_te * h * w:].reshape(seq.shape[0], Nf_te, h, w, C)
        return dec, enc.permute(1, 0, 4, 2, 3)

    def predict_filter(self, train_feat, test_feat, train_label, train_ltrb=None,
                       train_frame_mask=None, generator=None):
        """Returns (filters (Ns, K, C), enhanced test feature (Nf_te, Ns, C, h, w));
        `generator` draws the transformer's dropout masks in train mode."""
        Nf, Ns, C, H, W = train_feat.shape
        Nf_te, _, _, h, w = test_feat.shape
        seq = torch.cat([self._train_tokens(train_feat, train_label, train_ltrb),
                         _tokens(test_feat)], dim=1)
        pos = torch.cat([self._pos(train_feat), self._pos(test_feat)], dim=1)
        key_padding = None
        if train_frame_mask is not None:
            key_padding = _frame_key_padding(train_frame_mask, H * W,
                                             Nf_te * h * w).expand(Ns, -1)
        return self._decode(seq, pos, key_padding, test_feat, generator)

    def predict_cls_bbreg_filters_parallel(self, train_feat, test_feat, train_label,
                                           train_ltrb, train_frame_mask, gth_frame_mask):
        """The sequence batch is duplicated: copy 0 attends to every valid
        memory frame (classification filter), copy 1 only to the valid
        ground-truth frames (box regression filter).

        Returns (cls_filters, bbreg_filters, cls_enc, bbreg_enc): filters
        (Ns, K, C), enc (Nf_te, Ns, C, h, w)."""
        Nf, Ns, C, H, W = train_feat.shape
        Nf_te, _, _, h, w = test_feat.shape
        train_tok = self._train_tokens(_stack2(train_feat), _stack2(train_label),
                                       _stack2(train_ltrb))
        seq = torch.cat([train_tok, _tokens(_stack2(test_feat))], dim=1)
        pos = torch.cat([_stack2(self._pos(train_feat), 0),
                         _stack2(self._pos(test_feat), 0)], dim=1)
        valid = train_frame_mask.bool()
        row_cls = _frame_key_padding(valid, H * W, Nf_te * h * w)
        row_bb = _frame_key_padding(valid & gth_frame_mask.bool(), H * W, Nf_te * h * w)
        key_padding = torch.cat([row_cls.expand(Ns, -1), row_bb.expand(Ns, -1)], dim=0)
        dec, enc = self._decode(seq, pos, key_padding, test_feat)
        return dec[:Ns], dec[Ns:], enc[:, :Ns], enc[:, Ns:]
