"""Command line: run a training recipe of the port (counterpart of
pytracking_tpu/run_training.py).

    python -m pytracking_tpu_torch.run_training dimp dimp50 [--max_epochs N]
        [--device cuda]

Checkpoints go to <workspace>/checkpoints/<module>/<name>/epNNNN.ckpt
(training/settings.py), and a rerun resumes from the latest. The device
defaults to the card; without one it raises rather than train on the CPU.
"""

from __future__ import annotations

import argparse
import importlib
from typing import Optional, Sequence

from pytracking_tpu_torch.training.settings import Settings


def run_training(train_module: str, train_name: str, settings: Optional[Settings] = None,
                 **kwargs):
    """Runs train_settings/<train_module>/<train_name>.run; kwargs go to
    it (max_epochs, samples_per_epoch, net, device, ...). Returns the
    trainer."""
    print(f"Training: {train_module} {train_name}")
    settings = settings or Settings()
    settings.module_name, settings.script_name = train_module, train_name
    settings.project_path = f"{train_module}/{train_name}"
    expr = importlib.import_module(
        f"pytracking_tpu_torch.training.train_settings.{train_module}.{train_name}")
    return expr.run(settings, **kwargs)


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Run a training recipe.")
    parser.add_argument("train_module", type=str)
    parser.add_argument("train_name", type=str)
    parser.add_argument("--max_epochs", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    kwargs = {"device": args.device}
    if args.max_epochs is not None:
        kwargs["max_epochs"] = args.max_epochs
    run_training(args.train_module, args.train_name, **kwargs)


if __name__ == "__main__":
    main()
