"""The transformer's train mode in the port, on the CPU.

Routing: the hand-written attention kernel (K1, `ops.fused_mha`) has no
backward, so a TaMOs-shaped encoder (L >= 256, head dim 32) takes it only
in eval mode, as the JAX package takes its kernel only when
`deterministic`; in train mode it takes the plain attention, which
autograd differentiates; and the kernel's wrapper refuses an input that
requires grad while autograd records, on any device.

Dropout: flax's definition (keep probability 1 - rate, kept values divided
by it, one (Lq, Lk) attention-weight mask shared over batch and heads),
every mask drawn from the generator passed in: the same seed gives the same
forward bit for bit, another seed another one, and torch's global generator
is not touched. Shares are checked to within 1% of the keep probability
on draws of a million elements or more.
"""

import pytest
import torch

from pytracking_tpu_torch.models.transformer import transformer
from pytracking_tpu_torch.ops import fused_mha

D_MODEL, NHEAD = 64, 2              # head dim 32, the TaMOs encoder's
L = 300                             # >= FUSED_MIN_LEN


def _encoder(dropout=0.1):
    torch.manual_seed(0)
    return transformer.TransformerEncoderLayer(D_MODEL, NHEAD, dim_feedforward=96,
                                               dropout=dropout)


def _inputs(seed=0, B=2):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, L, D_MODEL, generator=g), torch.randn(B, L, D_MODEL, generator=g))


@pytest.fixture
def kernel_calls(monkeypatch):
    calls = []

    def recorder(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return fused_mha.fused_self_attention(*args, **kwargs)

    monkeypatch.setattr(transformer, "fused_self_attention", recorder)
    return calls


def test_eval_mode_under_inference_mode_takes_the_kernel_route(kernel_calls):
    layer = _encoder().eval()
    src, pos = _inputs()
    with torch.inference_mode():
        out = layer(src, pos)
    assert kernel_calls == [(2, L, NHEAD, D_MODEL // NHEAD)]
    assert bool(torch.isfinite(out).all())


def test_train_mode_takes_the_plain_route_and_has_gradients(kernel_calls):
    layer = _encoder().train()
    src, pos = _inputs()
    out = layer(src, pos, generator=torch.Generator().manual_seed(1))
    out.square().mean().backward()
    assert kernel_calls == []
    for name in ("query", "key", "value"):
        w = getattr(layer.self_attn, name).weight
        assert w.grad is not None and float(w.grad.abs().max()) > 0, name


def test_fused_wrapper_raises_on_inputs_that_require_grad():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, L, 2, 32, generator=g)
    fused_mha.fused_self_attention(q, q, q)                  # no grad: the plain version
    qg = q.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_mha.fused_self_attention(qg, q, q)
    with torch.no_grad():
        fused_mha.fused_self_attention(qg, qg, qg)
    with torch.inference_mode():
        fused_mha.fused_self_attention(q, q, q)


def test_eval_mode_with_autograd_on_raises_rather_than_detach(kernel_calls):
    """An eval-mode forward that records gradients would reach the kernel
    with parameters that require grad: it raises instead of returning an
    output cut off from them."""
    layer = _encoder().eval()
    src, pos = _inputs()
    with pytest.raises(RuntimeError, match="no backward"):
        layer(src, pos)


def test_train_mode_dropout_needs_an_explicit_generator():
    layer = _encoder().train()
    src, pos = _inputs()
    with pytest.raises(ValueError, match="generator"):
        layer(src, pos)
    _encoder(dropout=0.0).train()(src, pos)                   # no dropout: none needed


def test_dropout_keep_share_and_scale():
    x = torch.full((1000, 1000), 2.0)
    y = transformer.dropout(x, 0.1, torch.Generator().manual_seed(3))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.01 * 0.9
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0 / 0.9))


def test_attention_weight_mask_is_shared_over_batch_and_heads():
    """With V the identity over keys, the attention output is the dropped
    weights themselves: a weight is zero exactly where the (Lq, Lk) mask
    drops, in every batch entry and head alike; the share kept is 0.9."""
    B, H, Lq = 3, 4, 1000
    Lk = 1000
    q = torch.zeros(B, Lq, H, Lk)                             # uniform weights 1 / Lk
    k = torch.zeros(B, Lk, H, Lk)
    v = torch.eye(Lk).expand(B, H, Lk, Lk).permute(0, 2, 1, 3).contiguous()
    out = transformer._plain_attention(q, k, v, None, 0.1, torch.Generator().manual_seed(4))
    w = out.permute(0, 2, 1, 3)                               # (B, H, Lq, Lk)
    zero = w == 0
    assert torch.equal(zero, zero[:1, :1].expand_as(zero))
    assert abs(1 - float(zero[0, 0].float().mean()) - 0.9) < 0.01 * 0.9
    assert torch.allclose(w[~zero], torch.full_like(w[~zero], 1.0 / Lk / 0.9))


def _train_forward(seed):
    layer = _encoder().train()
    src, pos = _inputs()
    return layer(src, pos, generator=torch.Generator().manual_seed(seed))


def test_same_seed_same_step_other_seed_other_step_global_generator_untouched():
    a, b, c = _train_forward(7), _train_forward(7), _train_forward(8)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    layer = _encoder().train()
    src, pos = _inputs()
    before = torch.get_rng_state()
    layer(src, pos, generator=torch.Generator().manual_seed(7))
    assert torch.equal(torch.get_rng_state(), before)
