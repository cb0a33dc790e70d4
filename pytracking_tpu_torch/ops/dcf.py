"""Hann windows, Gaussian labels, Fourier-domain labels and interpolation
kernels, the spatial regularisation filter and 2-D argmax (counterpart of
pytracking_tpu/ops/dcf.py: `hann1d`, `hann2d`, `hann1d_uncentered`,
`hann2d_uncentered`, `hann2d_clipped`, `gauss_1d`, `gauss_2d`,
`gauss_fourier`, `label_function`, `label_function_spatial`,
`cubic_spline_fourier`, `get_interp_fourier`, `get_reg_filter`, `max2d`)."""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def hann1d(sz: int, device=None) -> torch.Tensor:
    """1-D Hann window of sz points, zero just outside both ends."""
    n = torch.arange(sz, dtype=torch.float32, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * (n + 1) / (sz + 1)))


def hann2d(sz: Tuple[int, int], device=None) -> torch.Tensor:
    """Outer-product 2-D Hann window, (H, W)."""
    return hann1d(sz[0], device=device)[:, None] * hann1d(sz[1], device=device)[None, :]


def hann1d_uncentered(sz: int, device=None) -> torch.Tensor:
    """Wrap-around 1-D cosine window of sz points with its peak at index 0
    (for the wrap-around score grids of ATOM and ECO)."""
    w = 0.5 * (1.0 + torch.cos((2.0 * math.pi / (sz + 2)) *
                               torch.arange(0, sz // 2 + 1, dtype=torch.float32,
                                            device=device)))
    return torch.cat([w, w[1:sz - sz // 2].flip(0)])


def hann2d_uncentered(sz: Tuple[int, int], device=None) -> torch.Tensor:
    """2-D wrap-around window, (H, W)."""
    return hann1d_uncentered(sz[0], device)[:, None] * hann1d_uncentered(sz[1], device)[None, :]


def hann2d_clipped(sz: Tuple[int, int], effective_sz: Tuple[int, int],
                   device=None) -> torch.Tensor:
    """2-D Hann window of `effective_sz`, centre-cropped to `sz` where it is
    larger and edge-padded to `sz` where it is smaller, (H, W)."""
    eh, ew = effective_sz
    win = hann2d((eh, ew), device=device)
    if eh > sz[0]:
        t = (eh - sz[0]) // 2
        win = win[t:t + sz[0], :]
        eh = sz[0]
    if ew > sz[1]:
        left = (ew - sz[1]) // 2
        win = win[:, left:left + sz[1]]
        ew = sz[1]
    pad_t = (sz[0] - eh) // 2
    pad_l = (sz[1] - ew) // 2
    pad = (pad_l, sz[1] - ew - pad_l, pad_t, sz[0] - eh - pad_t)
    return F.pad(win[None, None], pad, mode="replicate")[0, 0]


def gauss_1d(sz: int, sigma: torch.Tensor, center: torch.Tensor,
             end_pad: int = 0) -> torch.Tensor:
    """Sampled 1-D Gaussians on the grid -(sz-1)/2, ..., (sz-1)/2 + end_pad,
    centred at `center`. sigma and center broadcast: returns
    (..., sz + end_pad)."""
    k = torch.arange(sz + end_pad, dtype=torch.float32, device=center.device) - (sz - 1) / 2
    return torch.exp(-1.0 / (2.0 * sigma[..., None] ** 2) * (k - center[..., None]) ** 2)


def gauss_2d(sz: Tuple[int, int], sigma, center: torch.Tensor,
             end_pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Separable 2-D Gaussian labels. center (N, 2) as (y, x); sigma a scalar,
    a (2,) pair or (N, 2) per centre. Returns (N, H + end_pad[0],
    W + end_pad[1])."""
    center = torch.as_tensor(center, dtype=torch.float32)
    if center.dim() == 1:
        center = center[None]
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=center.device)
    sigma = torch.broadcast_to(sigma, center.shape)
    gy = gauss_1d(sz[0], sigma[:, 0], center[:, 0], end_pad[0])
    gx = gauss_1d(sz[1], sigma[:, 1], center[:, 1], end_pad[1])
    return gy[:, :, None] * gx[:, None, :]


def gauss_fourier(sz: int, sigma: float, half: bool = False, device=None) -> torch.Tensor:
    """Closed-form Fourier coefficients of a sampled Gaussian of std `sigma`
    on sz points, at the centred frequencies (the non-negative half with
    `half`)."""
    if half:
        k = torch.arange(0, int(sz / 2 + 1), dtype=torch.float32, device=device)
    else:
        k = torch.arange(-math.ceil((sz - 1) / 2), math.floor((sz - 1) / 2) + 1,
                         dtype=torch.float32, device=device)
    return math.sqrt(2 * math.pi) * sigma / sz * \
        torch.exp(-2.0 * (math.pi * sigma * k / sz) ** 2)


def label_function(sz: Tuple[int, int], sigma: Tuple[float, float],
                   device=None) -> torch.Tensor:
    """Centred-spectrum Gaussian label, real (H, W)."""
    return gauss_fourier(sz[0], sigma[0], device=device)[:, None] * \
        gauss_fourier(sz[1], sigma[1], device=device)[None, :]


def label_function_spatial(sz: Tuple[int, int], sigma, center: torch.Tensor,
                           end_pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Spatial Gaussian labels centred at `center` (y, x), offsets from the
    grid's middle: `gauss_2d`."""
    return gauss_2d(sz, sigma, center, end_pad)


def cubic_spline_fourier(f: torch.Tensor, a: float) -> torch.Tensor:
    """Fourier transform of the cubic interpolation kernel with parameter
    `a`, 1 at f = 0."""
    bf = (6.0 * (1.0 - torch.cos(2.0 * math.pi * f))
          + 3.0 * a * (1.0 - torch.cos(4.0 * math.pi * f))
          - (6.0 + a * 8.0) * math.pi * f * torch.sin(2.0 * math.pi * f)
          - 2.0 * a * math.pi * f * torch.sin(4.0 * math.pi * f)) \
        / (4.0 * math.pi ** 4 * f ** 4)
    return torch.where(f == 0.0, torch.ones_like(bf), bf)


def get_interp_fourier(sz: Tuple[int, int], method: str = "ideal", bicubic_a: float = -0.75,
                       centering: bool = True, windowing: bool = False,
                       device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fourier-domain interpolation kernel per axis ('ideal' or 'bicubic'),
    with a half-cell phase shift when `centering` and a Hann taper when
    `windowing`: complex64 (H, 1) and (1, W)."""
    ky = torch.arange(-math.ceil((sz[0] - 1) / 2), math.floor((sz[0] - 1) / 2) + 1,
                      dtype=torch.float32, device=device)
    kx = torch.arange(-math.ceil((sz[1] - 1) / 2), math.floor((sz[1] - 1) / 2) + 1,
                      dtype=torch.float32, device=device)
    if method == "ideal":
        fy = torch.ones_like(ky) / sz[0]
        fx = torch.ones_like(kx) / sz[1]
    elif method == "bicubic":
        fy = cubic_spline_fourier(ky / sz[0], bicubic_a) / sz[0]
        fx = cubic_spline_fourier(kx / sz[1], bicubic_a) / sz[1]
    else:
        raise ValueError(f"Unknown method {method}")
    fy = fy.to(torch.complex64)
    fx = fx.to(torch.complex64)
    if centering:
        fy = fy * torch.exp(-1j * math.pi / sz[0] * ky)
        fx = fx * torch.exp(-1j * math.pi / sz[1] * kx)
    if windowing:
        fy = fy * hann1d(sz[0], device)
        fx = fx * hann1d(sz[1], device)
    return fy[:, None], fx[None, :]


def get_reg_filter(sz: Tuple[int, int], target_sz: torch.Tensor, params) -> torch.Tensor:
    """Spatial regularisation filter in the Fourier domain, complex64: the
    DFT of the polynomial window (reg_window_edge - reg_window_min) *
    ((2|y| / h)^p + (2|x| / w)^p) + reg_window_min, coefficients below
    reg_sparsity_threshold of the largest set to 0. `params` may set
    use_reg_window, reg_window_min, reg_window_edge, reg_window_power and
    reg_sparsity_threshold."""
    device = target_sz.device
    if not getattr(params, "use_reg_window", True):
        return torch.tensor([[getattr(params, "reg_window_min", 1e-3)]], dtype=torch.float32,
                            device=device)
    reg_window_edge = getattr(params, "reg_window_edge", 10e-3)
    reg_window_min = getattr(params, "reg_window_min", 1e-4)
    reg_window_power = getattr(params, "reg_window_power", 2)
    reg_sparsity_threshold = getattr(params, "reg_sparsity_threshold", 0.05)
    wrg, wcg = (torch.arange(s, dtype=torch.float32, device=device) - (s - 1) / 2 for s in sz)
    wrs = 2.0 / target_sz[0] * torch.abs(wrg)
    wcs = 2.0 / target_sz[1] * torch.abs(wcg)
    reg_win = (reg_window_edge - reg_window_min) * \
        (wrs[:, None] ** reg_window_power + wcs[None, :] ** reg_window_power) + reg_window_min
    reg_win_dft = torch.fft.fftshift(torch.fft.fft2(reg_win)) / (sz[0] * sz[1])
    mx = torch.max(torch.abs(reg_win_dft))
    reg_win_dft = torch.where(torch.abs(reg_win_dft) >= reg_sparsity_threshold * mx,
                              reg_win_dft, 0.0)
    return reg_win_dft.to(torch.complex64)


def max2d(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max value and integer (row, col) argmax over the trailing two dims,
    batched over leading dims. Ties go to the first index in row-major order."""
    h, w = a.shape[-2], a.shape[-1]
    flat = a.reshape(a.shape[:-2] + (h * w,))
    max_val, idx = torch.max(flat, dim=-1)
    return max_val, torch.stack([idx // w, idx % w], dim=-1)
