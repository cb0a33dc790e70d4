"""Where the parameter modules find trained networks.

A parameter module whose JAX twin reads `<network_path>/<name>.msgpack`
reads `<network_path>/<name>.pth` here (`env_settings().network_path`:
PYTRACKING_TPU_TORCH_ROOT/networks, or PYTRACKING_TPU_TORCH_NETWORK_PATH).
`python -m pytracking_tpu_torch.ingest_checkpoint` writes such files from
upstream checkpoints. When the file's sidecar is absent the module draws its
seeded net, as the JAX modules fall back to `init`; a file that exists but
fails to load raises.
"""

from __future__ import annotations

import os
from typing import Callable

from torch import nn

from pytracking_tpu_torch.evaluation.environment import env_settings
from pytracking_tpu_torch.utils.loading import load_network


def load_or_seeded(name: str, seeded: Callable[[], nn.Module], device="cuda",
                   **overrides) -> nn.Module:
    """The net of the network file `name` on `device` (its constructor's
    keywords updated by `overrides`) when the file's sidecar exists, else
    `seeded()`."""
    path = os.path.join(env_settings().network_path, name + ".pth")
    if os.path.isfile(path + ".json"):
        return load_network(path, device=device, **overrides)
    return seeded()
