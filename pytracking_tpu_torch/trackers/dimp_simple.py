"""DiMP-simple tracker (counterpart of pytracking_tpu/trackers/dimp_simple.py):
DiMP's tracker; the net's filter optimiser is the generic Gauss-Newton
steepest descent (`models/classifier/residual_modules.py`)."""

from pytracking_tpu_torch.trackers.dimp import DiMPParams, DiMPTracker  # noqa: F401


def get_tracker_class():
    return DiMPTracker
