"""Centred 2-D Fourier series of correlation-filter trackers, on
torch.complex64 (counterpart of pytracking_tpu/ops/fourier.py: `cfft2`,
`cifft2`, `pad_fs`, `sample_fs`, `shift_fs`, `sum_fs`, `inner_prod_fs`).

Every spectrum is the full, fftshift'ed FFT over the last two dims, so the
zero frequency sits at index n // 2 of an axis of n: Fourier-domain
upsampling and the sum of spectra of different sizes are zero-pads. ECO
carries its maps as NCHW, so the last two dims are (H, W).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def cfft2(a: torch.Tensor) -> torch.Tensor:
    """Centred 2-D FFT over the last two dims, complex64."""
    return torch.fft.fftshift(torch.fft.fft2(a), dim=(-2, -1)).to(torch.complex64)


def cifft2(a_fs: torch.Tensor, signal_sizes: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverse of `cfft2`: the real part of the inverse FFT (zero-padded or
    cropped to `signal_sizes` where given)."""
    return torch.fft.ifft2(torch.fft.ifftshift(a_fs, dim=(-2, -1)), s=signal_sizes).real


def pad_fs(a_fs: torch.Tensor, grid_sz: Tuple[int, int]) -> torch.Tensor:
    """Zero-pad a centred spectrum to `grid_sz`, the zero frequency (index
    h // 2) landing at gh // 2: top pad gh // 2 - h // 2 (likewise left)."""
    h, w = a_fs.shape[-2], a_fs.shape[-1]
    gh, gw = int(grid_sz[0]), int(grid_sz[1])
    pt, pl = gh // 2 - h // 2, gw // 2 - w // 2
    return F.pad(a_fs, (pl, gw - w - pl, pt, gh - h - pt))


def sample_fs(a_fs: torch.Tensor, grid_sz: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The Fourier series sampled on a grid of `grid_sz` (the spectrum's own
    size when None): the inverse FFT of the zero-padded spectrum, scaled by
    the grid's point count."""
    if grid_sz is None:
        h, w = a_fs.shape[-2], a_fs.shape[-1]
        return (h * w) * cifft2(a_fs)
    gh, gw = int(grid_sz[0]), int(grid_sz[1])
    return (gh * gw) * cifft2(pad_fs(a_fs, (gh, gw)))


def _freq_grid(n: int, device) -> torch.Tensor:
    return torch.arange(-math.ceil((n - 1) / 2), math.floor((n - 1) / 2) + 1,
                        dtype=torch.float32, device=device)


def shift_fs(a_fs: torch.Tensor, shift) -> torch.Tensor:
    """Translate the series by a phase ramp: `shift` (..., 2) is (dy, dx) in
    units of 2π / size and broadcasts against the leading dims of a_fs."""
    ky = _freq_grid(a_fs.shape[-2], a_fs.device)
    kx = _freq_grid(a_fs.shape[-1], a_fs.device)
    shift = torch.as_tensor(shift, dtype=torch.float32, device=a_fs.device)
    ramp_y = torch.exp(1j * shift[..., 0:1] * ky)        # (..., H)
    ramp_x = torch.exp(1j * shift[..., 1:2] * kx)        # (..., W)
    return a_fs * ramp_y[..., :, None] * ramp_x[..., None, :]


def sum_fs(a_fs_list: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of centred spectra of different sizes, each zero-padded to the
    largest."""
    gh = max(int(a.shape[-2]) for a in a_fs_list)
    gw = max(int(a.shape[-1]) for a in a_fs_list)
    out = None
    for a in a_fs_list:
        p = pad_fs(a, (gh, gw))
        out = p if out is None else out + p
    return out


def inner_prod_fs(a_fs: torch.Tensor, b_fs: torch.Tensor) -> torch.Tensor:
    """The spatial inner product of two series from their spectra
    (Parseval): real(sum(conj(a) b)) / (H W)."""
    n = a_fs.shape[-2] * a_fs.shape[-1]
    return torch.real(torch.sum(torch.conj(a_fs) * b_fs)) / n
