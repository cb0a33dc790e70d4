"""Pack GOT-10k test results for the evaluation server (counterpart of
pytracking_tpu/util_scripts/pack_got10k_results.py):

    python -m pytracking_tpu_torch.util_scripts.pack_got10k_results dimp dimp50 <output_name>

Each of the 180 test sequences gets a folder with the boxes of three runs
(run ids none, 1 and 2 of `run_tracker --runid`), comma-separated, and the
first run's times; the folder tree becomes
<results_path>/got10k_packed/<output_name>.zip.
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from pytracking_tpu_torch.evaluation.environment import env_settings


def pack_got10k_results(tracker_name: str, param_name: str, output_name: str):
    env = env_settings()
    results_path = os.path.join(env.results_path, tracker_name, param_name)
    output_path = os.path.join(env.results_path, "got10k_packed", output_name)
    os.makedirs(output_path, exist_ok=True)

    for i in range(1, 181):
        seq_name = f"GOT-10k_Test_{i:06d}"
        seq_output_path = os.path.join(output_path, seq_name)
        os.makedirs(seq_output_path, exist_ok=True)
        for run_id in range(3):
            base = results_path if run_id == 0 else f"{results_path}_{run_id:03d}"
            res = np.loadtxt(os.path.join(base, f"{seq_name}.txt"), dtype=np.float64,
                             delimiter="\t")
            times = np.loadtxt(os.path.join(base, f"{seq_name}_time.txt"), dtype=np.float64)
            np.savetxt(os.path.join(seq_output_path, f"{seq_name}_{run_id + 1:03d}.txt"),
                       res, delimiter=",", fmt="%f")
            if run_id == 0:
                np.savetxt(os.path.join(seq_output_path, f"{seq_name}_time.txt"), times,
                           fmt="%f")

    shutil.make_archive(output_path, "zip", output_path)
    shutil.rmtree(output_path)
    print(f"Packed results to {output_path}.zip")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Pack GOT-10k results for the server.")
    parser.add_argument("tracker_name")
    parser.add_argument("param_name")
    parser.add_argument("output_name")
    a = parser.parse_args(argv)
    pack_got10k_results(a.tracker_name, a.param_name, a.output_name)


if __name__ == "__main__":
    main()
