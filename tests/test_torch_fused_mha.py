"""The port's fused self-attention (pytracking_tpu_torch/ops/fused_mha.py)
against the JAX package's Pallas kernel run in interpret mode on the CPU.

On the CPU the port's wrapper computes its plain PyTorch version; the CUDA
kernel itself is compared with that plain version on the card (the `cuda`
tests below, `python -m pytest tests/test_torch_fused_mha.py -m cuda`, and
chip_smoke.py)."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytracking_tpu.ops.pallas_mha import fused_self_attention as jax_fused
from pytracking_tpu_torch.ops import fused_mha


def _inputs(seed, B, L, H, D, masked, keep_frac=0.3):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, L, H, D).astype(np.float32) for _ in range(3))
    keep = (rng.rand(B, L) > keep_frac) if masked else None
    return q, k, v, keep


def _port(q, k, v, keep, dtype=torch.float32):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    mask = None if keep is None else torch.from_numpy(keep)
    return fused_mha.fused_self_attention(*t, key_keep_mask=mask)


@pytest.mark.parametrize("B,L,H,D,masked", [
    (2, 300, 8, 32, True),
    (2, 256, 8, 32, False),
    (1, 128, 4, 32, True),
    (2, 640, 2, 16, True),
])
def test_plain_version_matches_jax_kernel_f32(B, L, H, D, masked):
    q, k, v, keep = _inputs(0, B, L, H, D, masked)
    launches = fused_mha.fused_self_attention.launches
    out = _port(q, k, v, keep)
    ref = jax_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    key_keep_mask=None if keep is None else jnp.asarray(keep),
                    interpret=True)
    assert out.dtype == torch.float32 and out.shape == (B, L, H, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=2e-5)
    assert fused_mha.fused_self_attention.launches == launches   # no kernel on the CPU


def _slot_keep(B, L, frame, slot, entries):
    """Keep mask of an encoder sequence of frames of `frame` tokens with the
    frame slot `slot` masked in the given batch entries (the TaMOs memory)."""
    keep = np.ones((B, L), bool)
    keep[list(entries), slot * frame:(slot + 1) * frame] = False
    return keep


@pytest.mark.parametrize("L,frame,slot,entries", [
    (300, 100, 1, (0, 1)),    # slot edges at keys 100 and 200: inside 64-key tiles
    (300, 100, 0, (1,)),      # the first slot masked: the kernel skips the first tiles
    (288, 96, 1, (0, 1)),     # three frames of 96 tokens, ragged last tile
], ids=["edges_inside_tiles", "first_slot", "three_frames_of_96"])
def test_plain_version_matches_jax_kernel_on_frame_slot_masks(L, frame, slot, entries):
    B, H, D = 2, 2, 32
    q, k, v, _ = _inputs(4, B, L, H, D, False)
    keep = _slot_keep(B, L, frame, slot, entries)
    out = _port(q, k, v, keep)
    ref = jax_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    key_keep_mask=jnp.asarray(keep), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=2e-5)


def test_plain_version_bf16_close_to_f32_oracle_and_jax_kernel():
    q, k, v, keep = _inputs(1, 2, 384, 8, 32, True, keep_frac=0.2)
    out = _port(q, k, v, keep, torch.bfloat16)
    oracle = _port(q, k, v, keep)
    assert out.dtype == torch.bfloat16
    err = (out.float() - oracle).abs().max().item()
    assert err < 0.05, f"bf16 drifted {err} from the f32 oracle"
    jax_bf16 = jax_fused(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                         key_keep_mask=jnp.asarray(keep), interpret=True)
    diff = np.abs(out.float().numpy() - np.asarray(jax_bf16, np.float32)).max()
    assert diff < 0.05, diff


def test_fully_masked_row_gives_mean_of_values():
    """Declared deviation: a batch entry whose keys are all masked gets the
    mean of V over its L real keys (as the XLA attention of the JAX package
    gives), while the Pallas kernel's zero pad keys enter its softmax and it
    returns sum(V) / Lp, Lp = L rounded up to 128. Both are finite."""
    B, L, H, D = 2, 200, 4, 32
    q, k, v, _ = _inputs(2, B, L, H, D, False)
    keep = np.stack([np.zeros(L, bool), np.ones(L, bool)])
    out = _port(q, k, v, keep).numpy()
    ref = np.asarray(jax_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               key_keep_mask=jnp.asarray(keep), interpret=True))
    assert np.isfinite(out).all() and np.isfinite(ref).all()
    mean_v = v[0].mean(axis=0)                                   # (H, D)
    np.testing.assert_allclose(out[0], np.broadcast_to(mean_v, (L, H, D)), atol=2e-5)
    Lp = -(-L // 128) * 128
    np.testing.assert_allclose(ref[0], np.broadcast_to(v[0].sum(0) / Lp, (L, H, D)),
                               atol=2e-5)
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-5, atol=2e-5)


def test_rejects_cross_attention_and_bad_masks():
    q = torch.zeros(1, 128, 4, 32)
    k = torch.zeros(1, 256, 4, 32)
    with pytest.raises(ValueError):
        fused_mha.fused_self_attention(q, k, k)
    with pytest.raises(ValueError):
        fused_mha.fused_self_attention(q, q, q, key_keep_mask=torch.ones(1, 127, dtype=torch.bool))
    with pytest.raises(ValueError):
        fused_mha.fused_self_attention(q, q, q, key_keep_mask=torch.ones(1, 128))


def test_nvcc_command_targets_sm90a():
    cmd = fused_mha.nvcc_command("src.cu", "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == "src.cu" and "-shared" in cmd
    assert fused_mha.SOURCE.endswith("csrc/fused_mha.cu")


def test_build_digest_covers_every_source_file_and_the_flags(tmp_path, monkeypatch):
    """The build's cache key changes with any file under csrc/ (a header
    included by fused_mha.cu too) and with the nvcc flags, so a changed
    header never reuses a stale library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(fused_mha.CSRC_DIR, csrc)
    base = fused_mha.source_digest(str(csrc))
    assert base == fused_mha.source_digest(str(csrc))
    (csrc / "tiles.cuh").write_text("constexpr int kTile = 64;\n")
    with_header = fused_mha.source_digest(str(csrc))
    (csrc / "tiles.cuh").write_text("constexpr int kTile = 128;\n")
    changed_header = fused_mha.source_digest(str(csrc))
    assert len({base, with_header, changed_header}) == 3
    monkeypatch.setattr(fused_mha, "NVCC_FLAGS", fused_mha.NVCC_FLAGS + ("-lineinfo",))
    assert fused_mha.source_digest(str(csrc)) != changed_header
    pyproject = os.path.join(os.path.dirname(fused_mha.CSRC_DIR), "..", "pyproject.toml")
    with open(pyproject) as f:
        text = f.read()
    assert '"csrc/*.cu"' in text and '"csrc/*.cuh"' in text    # both shipped in the wheel


@pytest.mark.parametrize("Lq,Lk,D,fused", [(256, 256, 32, True), (300, 300, 32, True),
                                            (255, 255, 32, False), (10, 256, 32, False),
                                            (256, 256, 16, False)])
def test_attention_routes_to_kernel_only_where_it_is_built(monkeypatch, Lq, Lk, D, fused):
    """In eval mode with autograd off (as the trackers run), self-attention
    with L >= 256 and a head dim the kernel is built for goes through
    fused_self_attention; everything else is plain attention."""
    from pytracking_tpu_torch.models.transformer import transformer

    calls = []

    def recorder(*args, **kwargs):
        calls.append(args[0].shape)
        return fused_mha.fused_self_attention(*args, **kwargs)

    monkeypatch.setattr(transformer, "fused_self_attention", recorder)
    H = 2
    mha = transformer.MultiheadAttention(H * D, H).eval()
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, Lq, H * D, generator=g)
    kv = torch.randn(1, Lk, H * D, generator=g)
    with torch.inference_mode():
        out = mha(q, kv, kv)
    assert out.shape == (1, Lq, H * D) and bool(torch.isfinite(out).all())
    assert calls == ([(1, Lq, H, D)] if fused else [])


def test_attention_in_train_mode_takes_the_plain_route(monkeypatch):
    """Train mode never takes the kernel, which has no backward: a
    kernel-shaped self-attention (L 256, D 32) with autograd on goes through
    the plain attention, and its projections get gradients."""
    from pytracking_tpu_torch.models.transformer import transformer

    calls = []
    monkeypatch.setattr(transformer, "fused_self_attention",
                        lambda *a, **k: calls.append(1) or fused_mha.fused_self_attention(*a, **k))
    H, D, L = 2, 32, 256
    mha = transformer.MultiheadAttention(H * D, H).train()
    mha.dropout = 0.0                      # the routing alone; dropout has its own tests
    q = torch.randn(1, L, H * D, generator=torch.Generator().manual_seed(0))
    out = mha(q, q, q)
    out.square().mean().backward()
    assert calls == []
    assert all(float(getattr(mha, n).weight.grad.abs().max()) > 0 for n in ("query", "key"))


def _card_masks(B, L, rng):
    """The masks chip_smoke.py holds the kernel to, for one (B, L)."""
    frame = L // 3
    full = np.ones((B, L), bool)
    full[0] = False
    return {"main_path": _slot_keep(B, L, frame, 1, (0, 1)),
            "slot1_entry1": _slot_keep(B, L, frame, 1, (1,)),
            "slot0_entry0": _slot_keep(B, L, frame, 0, (0,)),
            "random_30pct": rng.rand(B, L) > 0.3,
            "none": None,
            "entry0_fully_masked": full}


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["main_path", "slot1_entry1", "slot0_entry0", "random_30pct",
                                  "none", "entry0_fully_masked"])
@pytest.mark.parametrize("dtype,B,L,H,D", [(torch.bfloat16, 2, 2592, 8, 32),
                                           (torch.bfloat16, 2, 300, 8, 32),
                                           (torch.bfloat16, 2, 40, 2, 32),
                                           (torch.float32, 2, 300, 8, 32)])
def test_cuda_kernel_matches_plain_version(dtype, B, L, H, D, mask):
    """The kernel on the card against its plain version: bf16 within 2e-2
    (and 0.05 of the float32 oracle), float32 at rtol 1e-5 / atol 2e-5; a
    fully masked entry gets the mean of V."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, _ = _inputs(3, B, L, H, D, False)
    keep = _card_masks(B, L, np.random.RandomState(5))[mask]
    t = [torch.from_numpy(x).to("cuda", dtype) for x in (q, k, v)]
    m = None if keep is None else torch.from_numpy(keep).cuda()
    launches = fused_mha.fused_self_attention.launches
    out = fused_mha.fused_self_attention(*t, key_keep_mask=m)
    torch.cuda.synchronize()
    assert fused_mha.fused_self_attention.launches == launches + 1
    ref = fused_mha.fused_self_attention_reference(*t, key_keep_mask=m)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=2e-5)
    else:
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2
        oracle = fused_mha.fused_self_attention_reference(*(x.float() for x in t),
                                                          key_keep_mask=m)
        assert (out.float() - oracle).abs().max().item() <= 0.05
    if mask == "entry0_fully_masked":
        mean_v = t[2][0].float().mean(0)
        assert (out[0].float() - mean_v).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("sm_scale", [-(32 ** -0.5), 0.0])
def test_cuda_bf16_kernel_other_scales(sm_scale):
    """A negative scale and a zero scale (every kept key one logit) against
    the plain version, on the main path's mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    B, L, H, D = 2, 2592, 8, 32
    q, k, v, _ = _inputs(6, B, L, H, D, False)
    t = [torch.from_numpy(x).to("cuda", torch.bfloat16) for x in (q, k, v)]
    m = torch.from_numpy(_slot_keep(B, L, L // 3, 1, (0, 1))).cuda()
    out = fused_mha.fused_self_attention(*t, key_keep_mask=m, sm_scale=sm_scale)
    ref = fused_mha.fused_self_attention_reference(*t, key_keep_mask=m, sm_scale=sm_scale)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
