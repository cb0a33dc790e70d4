"""How a parameter module reads PYTRACKING_TPU_BF16 / PYTRACKING_TPU_BF16_BACKBONE.

The JAX parameter modules read the two variables inside `parameters()`; the
port's take keyword arguments instead. A port module whose JAX twin reads a
variable sets its module attribute `precision_kwargs` to one of these
translations, `(bf16, bf16_backbone) -> keyword arguments of parameters()`,
and `evaluation.tracker.Tracker` passes what it returns. A module without
the attribute ignores both variables, as its JAX twin does.
"""

import torch


def dtype_or_backbone(bf16: bool, backbone: bool) -> dict:
    """BF16: the module's bf16 mode; BF16_BACKBONE alone: its bf16 backbone."""
    if bf16:
        return {"dtype": torch.bfloat16}
    return {"backbone_dtype": torch.bfloat16} if backbone else {}


def dtype_only(bf16: bool, backbone: bool) -> dict:
    """BF16 only: the module's bf16 mode."""
    return {"dtype": torch.bfloat16} if bf16 else {}


def backbone_only(bf16: bool, backbone: bool) -> dict:
    """Either variable: the bf16 backbone."""
    return {"backbone_dtype": torch.bfloat16} if bf16 or backbone else {}


def weights_only(bf16: bool, backbone: bool) -> dict:
    """BF16 only: every weight rounded through bf16."""
    return {"weights_bf16": True} if bf16 else {}
