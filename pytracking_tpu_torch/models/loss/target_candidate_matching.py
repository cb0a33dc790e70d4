"""KeepTrack's candidate-matching loss (counterpart of
pytracking_tpu/models/loss/target_candidate_matching.py
`target_candidate_matching_loss`, `matching_metrics`): the balanced negative
log-likelihood of the ground-truth assignment under the Sinkhorn log
assignment, with dustbin terms for the unmatchable candidates. Slots are
fixed: gt_matches entries are -2 for an invalid slot (ignored), -1 for an
unmatchable candidate (the dustbin) and >= 0 for the matched index.
"""

from __future__ import annotations

from typing import Dict

import torch


def target_candidate_matching_loss(log_assignment: torch.Tensor, gt_assignment: torch.Tensor,
                                   gt_matches0: torch.Tensor, gt_matches1: torch.Tensor,
                                   bin_score: torch.Tensor,
                                   nll_balancing: float = 0.5) -> Dict[str, torch.Tensor]:
    """log_assignment (B, M+1, N+1); gt_assignment (B, M, N) in {0, 1};
    gt_matches0 (B, M), gt_matches1 (B, N). Per sample, the matched pairs'
    NLL over their count and the dustbin NLL of the unmatchable ones over
    theirs (each count at least 1), mixed nll_balancing : 1 -
    nll_balancing; 'total' is the batch's mean. Also the means of nll_pos,
    nll_neg and the counts, the Sinkhorn rows' mass ('sinkhorn_norm') and
    the dustbin score."""
    positive = gt_assignment.to(torch.float32)
    neg0 = (gt_matches0 == -1).to(torch.float32)
    neg1 = (gt_matches1 == -1).to(torch.float32)

    num_pos = torch.clamp(positive.sum(dim=(1, 2)), min=1.0)
    num_neg = torch.clamp(neg0.sum(dim=1) + neg1.sum(dim=1), min=1.0)

    nll_pos = -(log_assignment[:, :-1, :-1] * positive).sum(dim=(1, 2)) / num_pos
    nll_neg0 = -(log_assignment[:, :-1, -1] * neg0).sum(dim=1)
    nll_neg1 = -(log_assignment[:, -1, :-1] * neg1).sum(dim=1)
    nll_neg = (nll_neg0 + nll_neg1) / num_neg

    nll = nll_balancing * nll_pos + (1.0 - nll_balancing) * nll_neg
    return {"total": nll.mean(), "nll_pos": nll_pos.mean(), "nll_neg": nll_neg.mean(),
            "num_matchable": num_pos.mean(), "num_unmatchable": num_neg.mean(),
            "sinkhorn_norm": torch.exp(log_assignment)[:, :-1].sum(dim=2).mean(),
            "bin_score": torch.as_tensor(bin_score).reshape(())}


def matching_metrics(matches1: torch.Tensor, gt_matches1: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Match recall over the valid slots (gt > -2) and precision over the
    predicted matches (> -1) among them; a count of 0 divides by 1."""
    valid = gt_matches1 > -2
    correct = (matches1 == gt_matches1) & valid
    recall = correct.sum() / torch.clamp(valid.sum(), min=1)
    predicted = (matches1 > -1) & valid
    precision = (correct & predicted).sum() / torch.clamp(predicted.sum(), min=1)
    return {"match_recall": recall, "match_precision": precision}
