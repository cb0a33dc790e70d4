"""Image patch extraction (counterpart of pytracking_tpu/ops/patch.py:
`bilinear_sample`, `_shrink_inside`, `_resample_weights` and `sample_patch`
with its three border modes).

The crop and resize is separable: two dense weight-matrix products
P = W_y · im · W_xᵀ, each row a normalised triangle filter whose width grows
with the downscale factor (anti-aliasing), out-of-range mass clamped onto
the border pixels; a mask (`is_mask`) is sampled at the nearest pixel
instead. The image is (C, H, W) here; the coordinate convention
is the JAX package's: output pixel j of a patch centred at `pos` with extent
`sample_sz` samples y(j) = pos_y + ((j + 0.5) / out_h - 0.5) * sample_sz_y.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def bilinear_sample(im: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    replicate: bool = True) -> torch.Tensor:
    """Bilinear lookup of im (C, H, W) at continuous coordinates ys, xs (one
    shape, pixel centres at integers). Outside the image the border pixel is
    repeated (replicate) or zero is read. Returns (C,) + ys.shape."""
    H, W = im.shape[-2], im.shape[-1]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    dy = ys - y0
    dx = xs - x0

    def tap(iy, ix):
        v = im[:, torch.clamp(iy, 0, H - 1).long(), torch.clamp(ix, 0, W - 1).long()]
        if not replicate:
            v = torch.where((iy >= 0) & (iy < H) & (ix >= 0) & (ix < W), v, 0.0)
        return v

    return ((1 - dy) * (1 - dx) * tap(y0, x0) + (1 - dy) * dx * tap(y0, x0 + 1)
            + dy * (1 - dx) * tap(y0 + 1, x0) + dy * dx * tap(y0 + 1, x0 + 1))


def _shrink_inside(pos: torch.Tensor, sample_sz: torch.Tensor, im_sz: torch.Tensor,
                   mode: str, max_scale_change) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 'inside' / 'inside_major' border modes: shrink the sample so that it
    fits the image along all axes ('inside') or the major one
    ('inside_major'), by at most `max_scale_change`, then shift it inside
    along each axis where it fits (else centre it on the image). pos and
    sample_sz are (..., 2), one sample per leading index."""
    shrink = sample_sz / im_sz
    shrink = shrink.amax(-1, keepdim=True) if mode == "inside" else shrink.amin(-1, keepdim=True)
    shrink = torch.clamp(shrink, min=1.0, max=max_scale_change or None)
    sample_sz = sample_sz / shrink
    tl = pos - sample_sz / 2
    br = pos + sample_sz / 2
    shift = torch.clamp(-tl - 0.5, min=0.0) - torch.clamp(br - (im_sz - 0.5), min=0.0)
    pos = torch.where(sample_sz <= im_sz, pos + shift, im_sz / 2 - 0.5)
    return pos, sample_sz


def _resample_weights(src_coords: torch.Tensor, src_size: int,
                      spread) -> torch.Tensor:
    """(..., out, src) matrix: row i is a triangle filter of width `spread`
    (>= 1; a number or a (...) tensor) centred at src_coords[..., i]
    (clamped into the image), normalised to sum 1."""
    grid = torch.arange(src_size, dtype=torch.float32, device=src_coords.device)
    c = torch.clamp(src_coords, 0.0, src_size - 1.0)
    if isinstance(spread, torch.Tensor):
        spread = spread[..., None, None]
    w = torch.clamp(1.0 - torch.abs(c[..., :, None] - grid) / spread, min=0.0)
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-8)


def sample_patch(im: torch.Tensor, pos: torch.Tensor, sample_sz: torch.Tensor,
                 output_sz: Tuple[int, int], mode: str = "replicate",
                 max_scale_change: Optional[float] = None,
                 im_sz: Optional[torch.Tensor] = None,
                 is_mask: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Patch of extent `sample_sz` (y, x) centred at `pos` (y, x) from
    im (C, H, W), resampled to output_sz. Reads outside the image repeat the
    border pixels. `mode` 'inside' / 'inside_major' first shrink and shift
    the sample into the image of size `im_sz` (y, x) (default im's own).
    With `is_mask` each output pixel takes the nearest image pixel, the
    coordinate rounded half to even as `jnp.round` does.

    pos and sample_sz may carry leading batch dims (B, 2): then one patch
    per sample, from im (C, H, W) or from its own image of im (B, C, H, W).

    Returns (patch (..., C, oh, ow) float32, coords (..., 4) = [tl_y, tl_x,
    br_y, br_x], the extent actually sampled)."""
    oh, ow = output_sz
    H, W = im.shape[-2], im.shape[-1]
    pos = pos.to(torch.float32)
    sample_sz = sample_sz.to(torch.float32)
    dev = im.device
    if mode in ("inside", "inside_major"):
        if im_sz is None:
            im_sz = torch.tensor([H, W], dtype=torch.float32, device=dev)
        pos, sample_sz = _shrink_inside(pos, sample_sz, im_sz.to(torch.float32), mode,
                                        max_scale_change)
    elif mode != "replicate":
        raise ValueError(f"unknown sample_patch mode {mode!r}")
    j = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) / oh - 0.5
    i = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) / ow - 0.5
    ys = pos[..., 0:1] + j * sample_sz[..., 0:1]                   # (..., oh)
    xs = pos[..., 1:2] + i * sample_sz[..., 1:2]                   # (..., ow)
    coords = torch.cat([pos - sample_sz / 2, pos + sample_sz / 2], dim=-1)
    if is_mask:
        iy = torch.clamp(torch.round(ys), 0, H - 1).long()
        ix = torch.clamp(torch.round(xs), 0, W - 1).long()
        im = im.expand(iy.shape[:-1] + im.shape[-3:])       # one image per sample
        rows = torch.take_along_dim(im, iy[..., None, :, None], dim=-2)
        return torch.take_along_dim(rows, ix[..., None, None, :], dim=-1).to(torch.float32), \
            coords
    wy = _resample_weights(ys, H, torch.clamp(sample_sz[..., 0] / oh, min=1.0))  # (..., oh, H)
    wx = _resample_weights(xs, W, torch.clamp(sample_sz[..., 1] / ow, min=1.0))  # (..., ow, W)
    if pos.dim() == 1:
        return torch.matmul(torch.matmul(wy, im.to(torch.float32)), wx.T), coords
    patch = torch.matmul(torch.matmul(wy.unsqueeze(-3), im.to(torch.float32)),
                         wx.unsqueeze(-3).transpose(-1, -2))
    return patch, coords
