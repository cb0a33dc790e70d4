"""Example experiments (counterpart of
pytracking_tpu/experiments/myexperiments.py). Each takes the device its
trackers run on. The NFS and UAV datasets are read from the trees that
PYTRACKING_TPU_NFS_PATH and PYTRACKING_TPU_UAV_PATH name."""

from pytracking_tpu_torch.evaluation.datasets import get_dataset
from pytracking_tpu_torch.evaluation.tracker import Tracker


def dimp_synthetic(device="cuda"):
    return [Tracker("dimp", "dimp50", device=device)], get_dataset("synthetic")


def atom_nfs_uav(device="cuda"):
    trackers = [Tracker("atom", "default", run_id=i, device=device) for i in range(3)]
    return trackers, get_dataset("nfs", "uav")


def uav_test(device="cuda"):
    trackers = [Tracker("atom", "default", device=device),
                Tracker("dimp", "dimp50", device=device),
                Tracker("dimp", "prdimp50", device=device)]
    return trackers, get_dataset("uav")
