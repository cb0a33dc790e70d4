"""Weight precision of the port's nets (counterpart of
pytracking_tpu/utils/loading.py `maybe_bf16_variables`)."""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def round_to_bf16_(net: nn.Module) -> nn.Module:
    """Round every float32 parameter and buffer of `net` through bfloat16, in
    place; they stay float32 tensors. The JAX package's bf16 mode stores
    them as bfloat16: where a layer computes in float32 it promotes them
    back, so the float32 layers (heads, box encoder, feature block) see the
    rounded values, as here. flax's BatchNorm with bf16 statistics computes
    its multiplier rsqrt(var + eps) * scale in bf16 arithmetic, and on a
    bf16 input (the bf16 backbone) the whole normalisation: the BatchNorms
    are marked to do the same (`BatchNorm.param_dtype`), and so are the
    filter optimisers, which compute their step length and regulariser
    from the parameters alone (`param_dtype`). A float32 net with
    rounded weights (LWL's `weights_bf16`) thus matches flax promoting bf16
    parameters to float32 activations."""
    for t in net.state_dict().values():
        if t.dtype == torch.float32:
            t.copy_(t.to(torch.bfloat16))
    for m in net.modules():
        if hasattr(m, "param_dtype"):
            m.param_dtype = torch.bfloat16
    return net
