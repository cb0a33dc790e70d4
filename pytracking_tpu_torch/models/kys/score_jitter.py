"""Score-map jittering for KYS training (counterpart of
pytracking_tpu/models/kys/score_jitter.py `DiMPScoreJittering`): the
appearance model's (DiMP's) score maps that the propagation module sees are
corrupted at random, a distractor peak raised to rival the target's or the
whole map zeroed, so that the module learns not to trust them blindly.

The draws come from an explicit `torch.Generator`, on the generator's
device: one on the scores' device draws there without a host
synchronisation; one on the CPU gives the same draws wherever the scores
are (they are copied up).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DiMPScoreJittering:
    """Per score map: the background cells are those whose label is below
    1e-4, the target's those above 0.2. With probability `p_distractor`, and
    if the background's peak exceeds `distractor_ratio` times the target's,
    the background's peak cell (its first, on ties) is set to a uniform draw
    in [min, max] enhance factor times the target's peak; otherwise, with
    probability `p_zero`, the map is zeroed. A map without a target (labels
    all below 0.2) has a target peak of 0: the ratio follows IEEE division
    (x / 0 is inf for x > 0, NaN for x = 0, which compares false), and a
    raised distractor peak becomes 0."""

    p_zero: float = 0.0
    distractor_ratio: float = 1.0
    p_distractor: float = 0.0
    max_distractor_enhance_factor: float = 1.0
    min_distractor_enhance_factor: float = 0.75

    def __call__(self, score: torch.Tensor, label: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
        """score, label (..., H, W), the leading axes independent maps (a
        label broadcasts to the score's shape). Returns the jittered
        scores. Draws, in this order: the distractor roll, the zero roll
        and the enhance fraction, one each per map."""
        shape = score.shape
        s = score.reshape(-1, shape[-2] * shape[-1])
        lab = torch.broadcast_to(label, shape).reshape(s.shape)
        u = torch.rand(3, s.shape[0], generator=generator,
                       device=generator.device).to(score.device)
        dist_roll, zero_roll, frac = u.unbind(0)

        score_neg = s * (lab < 1e-4)
        score_pos = s * (lab > 0.2)
        target_max = score_pos.amax(dim=1)
        dist_max = score_neg.amax(dim=1)
        dist_id = score_neg.argmax(dim=1)

        jitter = (dist_roll < self.p_distractor) & (dist_max / target_max > self.distractor_ratio)
        zero = (zero_roll < self.p_zero) & ~jitter
        lo = target_max * self.min_distractor_enhance_factor
        hi = target_max * self.max_distractor_enhance_factor
        enhance = frac * (hi - lo) + lo

        onehot = torch.nn.functional.one_hot(dist_id, s.shape[1]).to(s.dtype)
        s_enh = s * (1.0 - onehot) + enhance[:, None] * onehot
        out = torch.where(jitter[:, None], s_enh,
                          torch.where(zero[:, None], torch.zeros_like(s), s))
        return out.reshape(shape)
