"""Evaluate a tracker on a dataset (counterpart of
pytracking_tpu/run_tracker.py, with a `--device` option):

    python -m pytracking_tpu_torch.run_tracker dimp dimp50 --dataset_name synthetic
    python -m pytracking_tpu_torch.run_tracker dimp dimp50 --dataset_name synthetic --device cpu

Results go under `env_settings().results_path/<tracker>/<param>/`
(PYTRACKING_TPU_TORCH_ROOT, default ~/pytracking_tpu_torch_data; see
evaluation/environment.py). PYTRACKING_TPU_BF16 / _BF16_BACKBONE choose
the bf16 modes of the parameter modules that have them.
"""

from __future__ import annotations

import argparse

from pytracking_tpu_torch.evaluation.datasets import get_dataset
from pytracking_tpu_torch.evaluation.running import run_dataset
from pytracking_tpu_torch.evaluation.tracker import Tracker


def run_tracker(tracker_name: str, tracker_param: str, run_id=None,
                dataset_name: str = "synthetic", sequence=None, debug: int = 0,
                threads: int = 0, shard: int = 0, num_shards: int = 1,
                profile_dir=None, device="cuda"):
    """Run the tracker on the dataset (or one sequence of it, by name) on
    `device`; returns the `Tracker`, whose results_dir holds the files."""
    tracker = Tracker(tracker_name, tracker_param, run_id, device=device)
    dataset = get_dataset(dataset_name)
    if sequence is not None:
        dataset = [dataset[sequence]]
    run_dataset(dataset, [tracker], debug, threads, shard=shard, num_shards=num_shards,
                profile_dir=profile_dir)
    return tracker


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run tracker on a dataset.")
    p.add_argument("tracker_name", type=str)
    p.add_argument("tracker_param", type=str)
    p.add_argument("--runid", type=int, default=None)
    p.add_argument("--dataset_name", type=str, default="synthetic")
    p.add_argument("--sequence", type=str, default=None)
    p.add_argument("--debug", type=int, default=0)
    p.add_argument("--threads", type=int, default=0)
    p.add_argument("--shard", type=int, default=0,
                   help="this process's shard of the sequence list")
    p.add_argument("--num_shards", type=int, default=1, help="total eval processes/hosts")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the first sequence here")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default; fails without a card) or 'cpu'")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    run_tracker(args.tracker_name, args.tracker_param, args.runid, args.dataset_name,
                args.sequence, args.debug, args.threads, args.shard, args.num_shards,
                args.profile_dir, args.device)


if __name__ == "__main__":
    main()
