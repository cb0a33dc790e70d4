"""The VOT toolkit's entry (counterpart of pytracking_tpu/run_vot.py):

    python -m pytracking_tpu_torch.run_vot dimp dimp50 [--protocol vot2020|vot] [--device cuda]

The toolkit's manifests in pytracking_tpu_torch/VOT/ (trackers.ini for the
Python toolkit, tracker_DiMP.m for the MATLAB one) call
`pytracking_tpu_torch.run_vot.run_vot2020` / `run_vot` directly. The
tracker runs on the card unless `device` asks for the CPU.
"""

from __future__ import annotations

import argparse

from pytracking_tpu_torch.evaluation import vot as vot_protocol


def run_vot(tracker_name: str, tracker_param: str, run_id=None, device="cuda"):
    """The polygon protocol (VOT2018/19)."""
    vot_protocol.run_vot(tracker_name, tracker_param, run_id, device=device)


def run_vot2020(tracker_name: str, tracker_param: str, run_id=None, device="cuda"):
    """The mask protocol (VOT2020 and later)."""
    vot_protocol.run_vot2020(tracker_name, tracker_param, run_id, device=device)


def main(argv=None):
    parser = argparse.ArgumentParser(description="VOT protocol tracker entry.")
    parser.add_argument("tracker_name", type=str)
    parser.add_argument("tracker_param", type=str)
    parser.add_argument("--run_id", type=int, default=None)
    parser.add_argument("--protocol", type=str, default="vot2020", choices=["vot", "vot2020"])
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the default; fails without a card) or 'cpu'")
    args = parser.parse_args(argv)
    entry = run_vot2020 if args.protocol == "vot2020" else run_vot
    entry(args.tracker_name, args.tracker_param, args.run_id, device=args.device)


if __name__ == "__main__":
    main()
