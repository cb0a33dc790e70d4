"""Pack TrackingNet test results for the evaluation server (counterpart of
pytracking_tpu/util_scripts/pack_trackingnet_results.py):

    python -m pytracking_tpu_torch.util_scripts.pack_trackingnet_results dimp dimp50 [--output_name N]

Every box file of the run (not the timing files), comma-separated with two
decimals, zipped as <results_path>/trackingnet_packed/<output_name>.zip
(output_name defaults to the parameter name).
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from pytracking_tpu_torch.evaluation.environment import env_settings


def pack_trackingnet_results(tracker_name: str, param_name: str, output_name: str = None):
    env = env_settings()
    output_name = output_name or param_name
    results_path = os.path.join(env.results_path, tracker_name, param_name)
    output_path = os.path.join(env.results_path, "trackingnet_packed", output_name)
    os.makedirs(output_path, exist_ok=True)

    for fn in os.listdir(results_path):
        if not fn.endswith(".txt") or "_time" in fn:
            continue
        results = np.loadtxt(os.path.join(results_path, fn), dtype=np.float64, delimiter="\t")
        np.savetxt(os.path.join(output_path, fn), results, delimiter=",", fmt="%.2f")

    shutil.make_archive(output_path, "zip", output_path)
    shutil.rmtree(output_path)
    print(f"Packed results to {output_path}.zip")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Pack TrackingNet results for the server.")
    parser.add_argument("tracker_name")
    parser.add_argument("param_name")
    parser.add_argument("--output_name", default=None)
    a = parser.parse_args(argv)
    pack_trackingnet_results(a.tracker_name, a.param_name, a.output_name)


if __name__ == "__main__":
    main()
