"""Parity of the PyTorch port's DiMP ops with the JAX package, on the CPU.

Each port function and its JAX counterpart get the same numpy inputs (unit
scale, from seeds). Tolerances, each relative to the larger of 1 and the
result's largest magnitude: 1e-5 for the ops' values (float32 rounding and
the summation order of the convolutions and matmuls: correlations of 8-16
random channels reach magnitudes of ~20, where one float32 ulp is 2e-6),
1e-4 for gradients (a backward pass adds one more reduction). Feature maps are NHWC in JAX and NCHW in the port;
filters (B, fh, fw, C, K) in JAX and (B, K, C, fh, fw) in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytracking_tpu_torch.ops import activation as t_act
from pytracking_tpu_torch.ops import augmentation as t_aug
from pytracking_tpu_torch.ops import dcf as t_dcf
from pytracking_tpu_torch.ops import distance as t_distance
from pytracking_tpu_torch.ops import filter as t_filter
from pytracking_tpu_torch.ops import patch as t_patch
from pytracking_tpu_torch.ops import prroi_pool as t_prroi

OPS_ATOL = 1e-5
GRAD_ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _close(a, b, atol=OPS_ATOL):
    """|a - b| <= atol * max(1, max |b|)."""
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(np.asarray(a, np.float64), b,
                               atol=atol * max(1.0, np.abs(b).max()), rtol=0.0)


def _nchw(x):
    return _t(np.moveaxis(np.asarray(x, np.float32), -1, -3))


def _nhwc(x):
    return np.moveaxis(x.detach().numpy(), -3, -1)


def _filt_t(filt):
    """JAX filter (B, fh, fw, C, K) -> port (B, K, C, fh, fw)."""
    return _t(np.asarray(filt).transpose(0, 4, 3, 1, 2))


# ---------------------------------------------------------------- small ops

def test_distance_map_matches_jax():
    from pytracking_tpu.ops.distance import distance_map

    rng = np.random.RandomState(0)
    center = (rng.rand(5, 2) * 14 - 2).astype(np.float32)
    for bins, disp in ((10, 0.5), (100, 0.1), (5, 1.0)):
        ref = distance_map(jnp.asarray(center), (13, 15), bins, disp)
        _close(t_distance.distance_map(_t(center), (13, 15), bins, disp).numpy(), ref)


@pytest.mark.parametrize("name", ["leaky_relu_par", "leaky_relu_par_deriv", "bent_ident_par",
                                  "bent_ident_par_deriv", "mlu", "softmax_reg"])
def test_activation_matches_jax(name):
    from pytracking_tpu.ops import activation as j_act

    rng = np.random.RandomState(1)
    x = rng.randn(3, 7, 9).astype(np.float32) * 2
    x[0, 0, :3] = 0.0                                  # sign(0) and |0|
    a = rng.rand(3, 7, 9).astype(np.float32)
    if name == "mlu":
        ref, got = j_act.mlu(jnp.asarray(x), 0.05), t_act.mlu(_t(x), 0.05)
    elif name == "softmax_reg":
        ref = j_act.softmax_reg(jnp.asarray(x), axis=-1, reg=0.3)
        got = t_act.softmax_reg(_t(x), dim=-1, reg=0.3)
        _close(t_act.softmax_reg(_t(x), dim=1).numpy(), j_act.softmax_reg(jnp.asarray(x), 1))
    elif name.startswith("bent"):
        ref = getattr(j_act, name)(jnp.asarray(x), jnp.asarray(a), 0.05)
        got = getattr(t_act, name)(_t(x), _t(a), 0.05)
    else:
        ref = getattr(j_act, name)(jnp.asarray(x), jnp.asarray(a))
        got = getattr(t_act, name)(_t(x), _t(a))
    _close(got.numpy(), ref)


def test_hann_windows_match_jax():
    from pytracking_tpu.ops import dcf

    for sz in ((19, 19), (18, 23), (1, 5)):
        _close(t_dcf.hann2d(sz).numpy(), dcf.hann2d(sz))


# ---------------------------------------------------------------- filter

@pytest.mark.parametrize("mode", ["dimp", "same"])
@pytest.mark.parametrize("fsz", [(4, 4), (3, 5), (1, 1)])
def test_apply_filter_modes_match_jax(mode, fsz):
    from pytracking_tpu.ops.filter import apply_filter

    rng = np.random.RandomState(2)
    feat = rng.randn(3, 9, 11, 8).astype(np.float32)
    filt = rng.randn(3, fsz[0], fsz[1], 8, 2).astype(np.float32)
    ref = apply_filter(jnp.asarray(feat), jnp.asarray(filt), mode=mode)
    got = t_filter.apply_filter(_nchw(feat), _filt_t(filt), mode=mode)
    _close(_nhwc(got), ref)


def test_apply_filter_n_images_per_sequence_matches_jax_vmap():
    """feat (N, S, ...) against one filter per sequence: the optimiser's
    form, which JAX gets by vmapping apply_filter over N."""
    from pytracking_tpu.ops.filter import apply_filter

    rng = np.random.RandomState(3)
    feat = rng.randn(5, 2, 9, 9, 8).astype(np.float32)
    filt = rng.randn(2, 4, 4, 8, 1).astype(np.float32)
    ref = jax.vmap(lambda f: apply_filter(f, jnp.asarray(filt)))(jnp.asarray(feat))
    got = t_filter.apply_filter(_nchw(feat), _filt_t(filt))          # (N, S, 1, 10, 10)
    assert tuple(got.shape) == (5, 2, 1, 10, 10)
    _close(_nhwc(got), ref)


@pytest.mark.parametrize("form", ["per_sample", "n_images"])
def test_apply_feat_transpose_matches_autograd_and_jax(form):
    """The explicit grouped correlation against torch.autograd's gradient of
    <apply_filter(feat, w), act> in w, and against the JAX function (the
    VJP of its apply_filter), summed over the images in the N form."""
    from pytracking_tpu.ops.filter import apply_feat_transpose

    rng = np.random.RandomState(4)
    fsz = (4, 4)
    if form == "per_sample":
        feat = rng.randn(3, 9, 9, 8).astype(np.float32)
        act = rng.randn(3, 10, 10, 2).astype(np.float32)
        ref = apply_feat_transpose(jnp.asarray(feat), jnp.asarray(act), fsz)
        w = torch.zeros(3, 2, 8, 4, 4, requires_grad=True)
    else:
        feat = rng.randn(5, 2, 9, 9, 8).astype(np.float32)
        act = rng.randn(5, 2, 10, 10, 1).astype(np.float32)
        ref = jax.vmap(lambda f, a: apply_feat_transpose(f, a, fsz))(
            jnp.asarray(feat), jnp.asarray(act)).sum(0)
        w = torch.zeros(2, 1, 8, 4, 4, requires_grad=True)
    got = t_filter.apply_feat_transpose(_nchw(feat), _nchw(act), fsz)
    auto, = torch.autograd.grad((t_filter.apply_filter(_nchw(feat), w) * _nchw(act)).sum(), w)
    _close(got.numpy(), auto.numpy())
    _close(got.numpy(), _filt_t(np.asarray(ref)).numpy())


def test_filter_gradient_matches_jax():
    from pytracking_tpu.ops.filter import filter_gradient

    rng = np.random.RandomState(5)
    feat = rng.randn(2, 9, 9, 8).astype(np.float32)
    filt = rng.randn(2, 4, 4, 8, 1).astype(np.float32) * 0.1
    label = rng.randn(2, 10, 10, 1).astype(np.float32)
    ref = filter_gradient(jnp.asarray(feat), jnp.asarray(filt), jnp.asarray(label))
    got = t_filter.filter_gradient(_nchw(feat), _filt_t(filt), _nchw(label))
    _close(got.numpy(), _filt_t(np.asarray(ref)).numpy())


# ---------------------------------------------------------------- patch and augmentation

@pytest.mark.parametrize("replicate", [True, False])
def test_bilinear_sample_matches_jax(replicate):
    from pytracking_tpu.ops.patch import bilinear_sample

    rng = np.random.RandomState(6)
    im = rng.rand(12, 15, 3).astype(np.float32)
    ys = (rng.rand(7, 9) * 18 - 3).astype(np.float32)               # inside and outside
    xs = (rng.rand(7, 9) * 21 - 3).astype(np.float32)
    ref = bilinear_sample(jnp.asarray(im), jnp.asarray(ys), jnp.asarray(xs), replicate)
    got = t_patch.bilinear_sample(_nchw(im), _t(ys), _t(xs), replicate)
    _close(_nhwc(got), ref)


AUG_CASES = {
    "identity_shift": dict(kind="identity", shift=(5.0, -7.0)),
    "fliplr": dict(kind="fliplr", shift=(-3.0, 2.0)),
    "flipud": dict(kind="flipud"),
    "rotate": dict(kind="rotate", shift=(2.0, 1.0), angle=-45.0),
    "scale": dict(kind="scale", shift=(0.0, 4.0), scale=1.3),
    "blur": dict(kind="blur", shift=(1.0, -2.0), blur_sigma=(2.0, 0.7)),
}


@pytest.mark.parametrize("case", list(AUG_CASES))
def test_augmentation_kinds_match_jax(case):
    from pytracking_tpu.ops import augmentation as j_aug

    patch = np.random.RandomState(7).rand(40, 40, 3).astype(np.float32)
    ref = j_aug.apply_transform(jnp.asarray(patch), j_aug.AugTransform(**AUG_CASES[case]),
                                (24, 24))
    got = t_aug.apply_transform(_nchw(patch), t_aug.AugTransform(**AUG_CASES[case]), (24, 24))
    _close(_nhwc(got), ref)


def test_gaussian_blur_build_transforms_and_dropout_match_jax():
    from pytracking_tpu.ops import augmentation as j_aug

    im = np.random.RandomState(8).rand(20, 17, 3).astype(np.float32)
    for sigma in ((3, 1), (1, 3), (2, 2), (0.0, 1.5)):
        _close(_nhwc(t_aug.gaussian_blur(_nchw(im), sigma)),
               j_aug.gaussian_blur(jnp.asarray(im), sigma))
    augs = {"fliplr": True, "rotate": (10, -10, 45, -45), "blur": ((3, 1), (1, 3), (2, 2)),
            "relativeshift": ((0.6, 0.6), (-0.6, 0.6)), "shift": ((3, -2),), "scale": (1.1,)}
    ref = j_aug.build_transforms(augs, (288, 288), 1 / 3, np.random.RandomState(0))
    got = t_aug.build_transforms(augs, (288, 288), 1 / 3, np.random.RandomState(0))
    assert [vars(t) for t in got] == [vars(t) for t in ref]
    # every transform of the list at once
    patch = np.random.RandomState(9).rand(48, 48, 3).astype(np.float32)
    small = j_aug.build_transforms(augs, (32, 32), 1 / 3, np.random.RandomState(1))
    _close(np.moveaxis(t_aug.apply_all(_nchw(patch), t_aug.build_transforms(
        augs, (32, 32), 1 / 3, np.random.RandomState(1)), (32, 32)).numpy(), 1, -1),
        j_aug.apply_all(jnp.asarray(patch), small, (32, 32)))
    # dropout with the JAX key's mask
    feat = np.random.RandomState(10).randn(3, 5, 6, 16).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = j_aug.dropout2d(jnp.asarray(feat), key, 2, 0.2)
    keep = np.asarray(jax.random.bernoulli(key, 0.8, (2, 1, 1, 16)))
    got = t_aug.dropout2d(_nchw(feat), _nchw(keep), 0.2)
    _close(_nhwc(got), ref)


# ---------------------------------------------------------------- PrRoIPool

def _prroi_inputs(seed=11):
    rng = np.random.RandomState(seed)
    feat = rng.randn(2, 9, 11, 4).astype(np.float32)
    # boxes inside, across the border, sub-cell and degenerate-thin
    rois = np.array([[8.0, 6.0, 60.0, 50.0], [-10.0, 20.0, 30.0, 80.0],
                     [40.0, 30.0, 43.0, 35.0], [70.0, 10.0, 100.0, 70.0],
                     [5.3, 7.9, 77.1, 41.6]], np.float32)
    bidx = np.array([0, 1, 0, 1, 1], np.int32)
    return feat, rois, bidx


@pytest.mark.parametrize("out", [(5, 5), (3, 3), (1, 1), (4, 4)])
def test_prroi_pool_values_match_jax_and_brute(out):
    from pytracking_tpu.ops.prroi_pool import prroi_pool2d, prroi_pool2d_brute

    feat, rois, bidx = _prroi_inputs()
    ref = prroi_pool2d(jnp.asarray(feat), jnp.asarray(rois), jnp.asarray(bidx), out, 1 / 8)
    got = t_prroi.prroi_pool2d(_nchw(feat), _t(rois), torch.from_numpy(bidx).long(), out,
                               1 / 8)
    _close(_nhwc(got), ref)
    # the closed form against numerical integration of the bilinear surface
    # (the RoI that crosses the image border)
    brute = prroi_pool2d_brute(jnp.asarray(feat), jnp.asarray(rois[1:2]),
                               jnp.asarray(bidx[1:2]), out, 1 / 8, samples=64)
    _close(_nhwc(got[1:2]), brute, atol=2e-3)


def test_prroi_pool_gradients_match_jax_grad():
    """d/d(boxes) and d/d(features) of a weighted sum of the pooled values,
    port autograd against jax.grad."""
    from pytracking_tpu.ops.prroi_pool import prroi_pool2d

    feat, rois, bidx = _prroi_inputs(12)
    cot = np.random.RandomState(13).randn(5, 5, 5, 4).astype(np.float32)

    def jloss(f, r):
        return jnp.sum(prroi_pool2d(f, r, jnp.asarray(bidx), (5, 5), 1 / 8) * cot)

    gf_ref, gr_ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(feat), jnp.asarray(rois))
    f = _nchw(feat).requires_grad_(True)
    r = _t(rois).requires_grad_(True)
    loss = (t_prroi.prroi_pool2d(f, r, torch.from_numpy(bidx).long(), (5, 5), 1 / 8)
            * _nchw(cot)).sum()
    gf, gr = torch.autograd.grad(loss, (f, r))
    _close(_nhwc(gf), gf_ref, atol=GRAD_ATOL)
    _close(gr.numpy(), gr_ref, atol=GRAD_ATOL)
    assert np.abs(np.asarray(gr_ref)).max() > 1e-2                # the box gradient is live
