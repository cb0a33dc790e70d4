"""Run a predefined experiment (counterpart of
pytracking_tpu/run_experiment.py, with a `--device` option). An experiment
is a function of a module in `pytracking_tpu_torch/experiments/` that takes
`device` and returns (trackers, dataset):

    python -m pytracking_tpu_torch.run_experiment myexperiments dimp_synthetic
"""

from __future__ import annotations

import argparse
import importlib


def run_experiment(experiment_module: str, experiment_name: str, debug: int = 0,
                   threads: int = 0, device="cuda"):
    from pytracking_tpu_torch.evaluation.running import run_dataset

    module = importlib.import_module(f"pytracking_tpu_torch.experiments.{experiment_module}")
    trackers, dataset = getattr(module, experiment_name)(device=device)
    print(f"Running: {experiment_module} {experiment_name}")
    run_dataset(dataset, trackers, debug, threads)
    return trackers


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run a predefined experiment.")
    p.add_argument("experiment_module", type=str)
    p.add_argument("experiment_name", type=str)
    p.add_argument("--debug", type=int, default=0)
    p.add_argument("--threads", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default; fails without a card) or 'cpu'")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    run_experiment(args.experiment_module, args.experiment_name, args.debug, args.threads,
                   args.device)


if __name__ == "__main__":
    main()
