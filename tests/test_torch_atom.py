"""Parity of the PyTorch port's ATOM (pytracking_tpu_torch/models/tracking/
atomnet.py, trackers/atom.py, parameter/atom/*) with the JAX package, on the
CPU.

The tiny ATOM of tests/test_atom_tracker.py (ResNet with one BasicBlock per
stage at base width 16, IoU-Net on (32, 64) channels with 32-wide heads),
its JAX `net.init` with random BatchNorm statistics converted by
`atomnet_from_flax`. Float32 throughout. Tolerances: modules 1e-4 of the
larger of 1 and the output's largest magnitude; traces: flags equal, boxes
within 1e-3 px, memory weights within 1e-6, projection and filter within
1e-4 of scale after the init and after every refit. The port's draws (the
projection and filter init, the dropout mask, the box jitter) are replaced
by the JAX tracker's own, from its key with its splits.
"""

import dataclasses
import importlib
import traceback
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pytracking_tpu_torch.models.backbones import resnet as t_resnet
from pytracking_tpu_torch.models.bbreg.iou_net import AtomIoUNet as TAtomIoUNet
from pytracking_tpu_torch.models.tracking import atomnet as t_atomnet
from pytracking_tpu_torch.trackers import atom as t_atom
from pytracking_tpu_torch.utils.convert_weights import atomnet_from_flax
from test_torch_lwl_ops import one_thread  # noqa: F401 (autouse: one CPU thread)
from test_torch_dimp import _perturb_batch_stats

ATOL = 1e-4
CIN = 64                         # layer3 channels of the tiny net
# tests/test_atom_tracker.py's tracker at one Gauss-Newton step of 8 CG
# iterations for the joint init fit: with these random weights the second
# step's CG loses conjugacy (p·Ap falls from 1e8 to 4e2 within two
# iterations, the residual grows), where float32 rounding decides the
# result: JAX's own jitted and eager runs part by ~10% there (12 CG over 3
# steps, the smoke test's), and the solver is held over several steps on
# well-conditioned problems in tests/test_torch_solvers.py instead.
TRACE_KW = dict(max_image_sample_size=96 ** 2, min_image_sample_size=96 ** 2,
                compressed_dim=16, sample_memory_size=10, init_CG_iter=8, init_GN_iter=1,
                CG_iter=2, hard_negative_CG_iter=2, train_skipping=4,
                augmentation=(("fliplr", True), ("rotate", (10,)), ("dropout", (1, 0.2))),
                num_init_random_boxes=3, box_refinement_iter=2, iounet_k=2)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(a, b, atol=ATOL):
    """|a - b| <= atol * max(1, max |b|)."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(np.asarray(a, np.float64), b,
                               atol=atol * max(1.0, np.abs(b).max()), rtol=0.0)


class _HostTensors(TorchDispatchMode):
    """Counts tensors made from host data (`torch.tensor` of Python values,
    `torch.from_numpy`) inside a step: on the card each is an upload that
    synchronises the host, so a step may make one, the frame."""

    def __init__(self):
        super().__init__()
        self.count, self.where = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.lift_fresh.default:
            self.count += 1
            self.where.append(traceback.format_stack(limit=4)[0])
        return func(*args, **(kwargs or {}))


def _nhwc(x):
    return np.moveaxis(x.detach().numpy(), -3, -1)


@pytest.fixture(scope="module")
def nets():
    """(jax net, flax variables as numpy, torch net with the same weights)."""
    from tests.test_atom_tracker import tiny_atomnet

    jnet = tiny_atomnet()
    dummy = jnp.zeros((1, 1, 96, 96, 3))
    bb = jnp.array([[[30.0, 30.0, 20.0, 20.0]]])
    variables = jax.jit(lambda k: jnet.init(k, dummy, dummy, bb, bb[:, :, None], train=False))(
        jax.random.PRNGKey(0))
    variables = _perturb_batch_stats(jax.tree_util.tree_map(np.asarray, dict(variables)), 5)
    tnet = t_atomnet.ATOMnet(
        t_resnet.ResNet(layers=(1, 1, 1, 1), output_layers=("layer2", "layer3"),
                        base_width=16, block="basic"),
        TAtomIoUNet(input_dim=(32, 64), pred_input_dim=(32, 32), pred_inter_dim=(32, 32))).eval()
    tnet.load_state_dict(atomnet_from_flax(variables, tnet))
    return jnet, variables, tnet


def test_converter_uses_every_leaf_and_key(nets):
    _, variables, tnet = nets
    sd = atomnet_from_flax(variables, tnet)
    assert len(sd) == len(jax.tree_util.tree_leaves(variables)) == len(tnet.state_dict())
    broken = dict(variables, params=dict(variables["params"], extra={"kernel": np.zeros((2, 2))}))
    with pytest.raises(KeyError):
        atomnet_from_flax(broken, tnet)
    smaller = dict(variables, params={k: v for k, v in variables["params"].items()
                                      if k != "bb_regressor"})
    with pytest.raises(KeyError):
        atomnet_from_flax(smaller, tnet)


def test_full_width_net_keys_match_jax():
    """atom_resnet18's state_dict has the keys and shapes of the JAX
    atom_resnet18's variables (by `jax.eval_shape`, nothing initialised)."""
    from pytracking_tpu.models.tracking.atomnet import atom_resnet18

    jnet = atom_resnet18()
    im = jnp.zeros((1, 1, 96, 96, 3))
    bb = jnp.zeros((1, 1, 4))
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), im, im, bb, bb[:, :, None],
                                              train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    with torch.device("meta"):
        tnet = t_atomnet.ATOMnet(t_resnet.resnet18(),
                                 TAtomIoUNet(input_dim=(128, 256), pred_input_dim=(256, 256),
                                             pred_inter_dim=(256, 256)))
    assert len(atomnet_from_flax(zeros, tnet)) == len(tnet.state_dict())


def test_net_outputs_match_jax(nets):
    """Backbone layer2/layer3, the IoU features, the modulation and the
    IoU prediction with its gradient in the boxes."""
    jnet, variables, tnet = nets
    rng = np.random.RandomState(0)
    im = rng.uniform(0, 255, (2, 96, 96, 3)).astype(np.float32)
    jf = jax.jit(lambda v, x: jnet.apply(v, x, method=lambda m, x: m.extract_backbone(x)))(
        variables, im)
    with torch.no_grad():
        tf = tnet.extract_backbone(_t(np.moveaxis(im, -1, 1)))
    for k in ("layer2", "layer3"):
        _close(_nhwc(tf[k]), jf[k])
    boxes = np.array([[20.0, 24.0, 30.0, 26.0], [40.0, 30.0, 22.0, 34.0]], np.float32)
    props = boxes[:, None] + rng.uniform(-3, 3, (2, 5, 4)).astype(np.float32)

    def jax_iou(v, f, bb, p):
        mod = v_apply(v, f, bb, "iou_get_modulation")
        feat = v_apply(v, f, None, "iou_get_iou_feat")
        return mod, feat, jnet.apply(v, mod, feat, p,
                                     method=lambda m, mo, fe, pp: m.iou_predict(mo, fe, pp))

    def v_apply(v, f, bb, name):
        if bb is None:
            return jnet.apply(v, f, method=lambda m, f: getattr(m, name)(f))
        return jnet.apply(v, f, bb, method=lambda m, f, b: getattr(m, name)(f, b))

    jmod, jfeat, jiou = jax.jit(jax_iou)(variables, jf, boxes, props)
    tb = tnet.get_backbone_bbreg_feat(tf)
    with torch.no_grad():
        tmod = tnet.bb_regressor.get_modulation(tb, _t(boxes))
        tfeat = tnet.bb_regressor.get_iou_feat(tb)
    for a, b in zip(tmod, jmod):
        _close(a, b)
    for a, b in zip(tfeat, jfeat):
        _close(_nhwc(a), b)
    p = _t(props).requires_grad_(True)
    tiou = tnet.bb_regressor.predict_iou(tmod, tfeat, p)
    _close(tiou, jiou)
    grad, = torch.autograd.grad(tiou.sum(), p)
    jgrad = jax.grad(lambda pp: jnet.apply(
        variables, jmod, jfeat, pp, method=lambda m, mo, fe, q: m.iou_predict(mo, fe, q)).sum())(
        jnp.asarray(props))
    _close(grad, jgrad)


# ---------------------------------------------------------------- localisation

LOCALIZE_CASES = {
    # name: (peak 1 (value, (row, col)), peak 2 or None, expected flag)
    "normal": ((1.0, (1, 2)), None, t_atom.FLAG_NORMAL),
    "not_found": ((0.2, (1, 2)), None, t_atom.FLAG_NOT_FOUND),
    "hard_negative_second_peak": ((1.0, (1, 2)), (0.6, (24, 30)), t_atom.FLAG_HARD_NEG),
    "hard_negative_distractor_far": ((1.0, (1, 2)), (0.9, (30, 30)), t_atom.FLAG_HARD_NEG),
    "hard_negative_target_moved": ((1.0, (30, 30)), (0.9, (1, 2)), t_atom.FLAG_HARD_NEG),
    "uncertain": ((1.0, (1, 2)), (0.9, (1, 14)), t_atom.FLAG_UNCERTAIN),
}


@pytest.mark.parametrize("case", list(LOCALIZE_CASES))
def test_localize_matches_jax(case):
    """Both localisations on the same wrap-around score maps (two scales,
    64x64 grid, peaks given): equal flags, scale index, translation and
    score."""
    from pytracking_tpu.trackers.atom import ATOMParams, ATOMTracker

    (v1, p1), second, expected = LOCALIZE_CASES[case]
    out_sz = 64
    scores = np.zeros((2, out_sz, out_sz), np.float32)
    scores[1][p1] = v1
    scores[0][p1] = 0.5 * v1
    if second is not None:
        scores[1][second[1]] = second[0]
    state_np = types.SimpleNamespace(target_sz=np.array([14.0, 10.0], np.float32))
    factors = np.array([0.9, 1.1], np.float32)
    jtr = ATOMTracker.__new__(ATOMTracker)
    jtr.params = ATOMParams()
    ref = jtr._localize(types.SimpleNamespace(target_sz=jnp.asarray(state_np.target_sz)),
                        jnp.asarray(scores), jnp.asarray(factors), out_sz,
                        jnp.full(2, 64.0))
    ttr = t_atom.ATOMTracker(t_atom.ATOMParams(), torch.nn.Identity(), device="cpu")
    ttr._sample_sz, ttr._support = 64, _t([64.0, 64.0])
    got = ttr._localize(types.SimpleNamespace(target_sz=_t(state_np.target_sz)), _t(scores),
                        _t(factors), out_sz, _t(scores))
    assert int(got[2]) == int(ref[2]) == expected
    assert int(got[1]) == int(ref[1]) == 1
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5)
    assert float(got[3]) == float(ref[3])


# ---------------------------------------------------------------- tracker

def _frame(t, H=128, W=128):
    """The target moving (+2, +3) px per frame; from frame 5 a copy of it
    moving left along the top edge."""
    im = np.full((H, W, 3), 30, np.uint8)
    cy, cx = 56 + 2 * t, 52 + 3 * t
    im[cy - 10:cy + 10, cx - 9:cx + 9] = [220, 60, 60]
    if t >= 5:
        im[10:30, 91 - 3 * t:109 - 3 * t] = [220, 60, 60]
    return im


def _injected_pair(nets, kw):
    """The JAX tracker and the port's with the JAX tracker's init draws fed
    to the port's `_keep_mask` and `_normal`."""
    from pytracking_tpu.trackers.atom import ATOMParams, ATOMTracker

    jnet, variables, tnet = nets
    jtr = ATOMTracker(ATOMParams(**kw), jnet, variables)
    ttr = t_atom.ATOMTracker(t_atom.ATOMParams(**kw), tnet, device="cpu")
    key = jax.random.PRNGKey(0)
    augs = ttr.params.aug_dict()
    if "dropout" in augs:
        key, dkey = jax.random.split(key)
        n_drop, prob = augs["dropout"]
        keep = np.asarray(jax.random.bernoulli(dkey, 1.0 - prob, (n_drop, 1, 1, CIN)))
        ttr._keep_mask = lambda shape, p: torch.from_numpy(keep.transpose(0, 3, 1, 2).copy())
    key, pkey, fkey = jax.random.split(key, 3)
    fh, fw = ttr.params.kernel_size
    cdim = ttr.params.compressed_dim
    normals = [_t(np.asarray(jax.random.normal(pkey, (1, 1, CIN, cdim)))[0, 0]),
               _t(np.asarray(jax.random.normal(fkey, (fh, fw, cdim, 1))).transpose(3, 2, 0, 1))]

    def normal(shape):
        out = normals.pop(0)
        assert tuple(out.shape) == tuple(shape)
        return out

    ttr._normal = normal
    return jtr, ttr


def _filters_close(ts, js):
    _close(ts.proj, np.asarray(js.proj)[0, 0])
    _close(ts.filt, np.asarray(js.filt).transpose(3, 2, 0, 1))


def _trace(nets, kw, n_frames):
    """initialize + n_frames of both trackers; per frame flags, boxes,
    scores, counters, memory weights, samples and labels, and the filter.
    Returns (flags, refit iterations) per frame."""
    jtr, ttr = _injected_pair(nets, kw)
    info = {"init_bbox": [43.0, 46.0, 18.0, 20.0]}
    jtr.initialize(_frame(0), info)
    ttr.initialize(_frame(0), info)
    js, ts = jtr.state, ttr.state
    _filters_close(ts, js)
    _close(_nhwc(ts.mem_samples), js.mem_samples)
    _close(ts.mem_y, js.mem_y)
    flags, iters = [], []
    for t in range(1, n_frames + 1):
        jitter = jax.random.uniform(jax.random.split(jtr.state.key)[1],
                                    (kw["num_init_random_boxes"], 4))
        ttr._uniform = lambda shape, u=_t(jitter): u
        jo = jtr.track(_frame(t))
        with _HostTensors() as made:
            to = ttr.track(_frame(t))
        assert made.count == 1, made.where      # the frame alone
        js, ts = jtr.state, ttr.state
        assert to["flag"] == jo["flag"], (t, to, jo)
        np.testing.assert_allclose(to["target_bbox"], jo["target_bbox"], atol=1e-3, rtol=0)
        assert abs(to["max_score"] - jo["max_score"]) <= 1e-4 * max(1, abs(jo["max_score"]))
        for name in ("num_stored", "prev_ind", "frame_num"):
            assert int(getattr(ts, name)) == int(getattr(js, name)), name
        np.testing.assert_allclose(ts.mem_weights.numpy(), js.mem_weights, atol=1e-6, rtol=0)
        _close(_nhwc(ts.mem_samples), js.mem_samples)
        _close(ts.mem_y, js.mem_y)
        _filters_close(ts, js)
        flags.append(to["flag"])
        iters.append(ttr._refit_iterations(t_atom.FLAG_NAMES.index(to["flag"]), ts.frame_num))
    return flags, iters


def test_tracker_trace_matches_jax(nets):
    """initialize + 12 frames on 128x128 frames (the JAX package's 128-pixel
    shape bucket pads nothing): frame 6 is a hard negative (the distractor's
    peak), the others normal; periodic refits at frames 4, 8 and 12
    (train_skipping 4) and the hard-negative refit at 6; the memory of 10
    fills after 6 updates and then replaces its lightest slot."""
    flags, iters = _trace(nets, TRACE_KW, 12)
    assert flags[5] == "hard_negative" and flags.count("normal") == 11, flags
    assert iters == [0, 0, 0, 2, 0, 2, 0, 2, 0, 0, 0, 2], iters


def test_tracker_trace_relative_pair_step_matches_jax(nets):
    """atom_prob_ml's box refinement: the relative box space, a (pos, sz)
    step pair of (2e-4, 10e-4); 5 frames."""
    kw = dict(TRACE_KW, box_refinement_space="relative", box_refinement_iter=3,
              box_refinement_step_length=(2e-4, 10e-4))
    _trace(nets, kw, 5)


def test_pca_projection_matches_jax_up_to_sign(nets):
    """proj_init_method='pca': the init's projection (singular vectors,
    unique up to sign) after aligning each column's sign, and the filter
    after the joint fit with the matching channel signs; the first frames'
    boxes and flags equal."""
    kw = dict(TRACE_KW, proj_init_method="pca", augmentation=(("fliplr", True),))
    jtr, ttr = _injected_pair(nets, kw)
    ttr._normal = lambda shape: _t(np.asarray(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(0), 3)[2], (4, 4, 16, 1))).transpose(3, 2, 0, 1))
    info = {"init_bbox": [43.0, 46.0, 18.0, 20.0]}
    jtr.initialize(_frame(0), info)
    ttr.initialize(_frame(0), info)
    jp = np.asarray(jtr.state.proj)[0, 0]
    tp = ttr.state.proj.numpy()
    sign = np.sign(np.sum(jp * tp, axis=0))
    _close(tp * sign, jp)
    _close(ttr.state.filt.numpy() * sign[None, :, None, None],
           np.asarray(jtr.state.filt).transpose(3, 2, 0, 1))


# ---------------------------------------------------------------- parameters

MODULES = ("default", "default_vot", "atom_prob_ml", "atom_gmm_sampl", "multiscale_no_iounet")


def test_params_dataclass_matches_jax():
    from pytracking_tpu.trackers.atom import ATOMParams

    ref = [f.name for f in dataclasses.fields(ATOMParams)]
    assert [f.name for f in dataclasses.fields(t_atom.ATOMParams)] == ref
    assert ATOMParams() == ATOMParams(**dataclasses.asdict(t_atom.ATOMParams()))


@pytest.mark.parametrize("name", MODULES)
def test_parameter_module_matches_jax(name, monkeypatch, tmp_path):
    """The port module's params equal the JAX module's (nets, env_settings
    and variable loading stubbed on the JAX modules, nothing initialised),
    and its net is atom_resnet18 from the given seed on the given device."""
    env = types.SimpleNamespace(network_path=str(tmp_path / "absent"))
    for mod_name in ("default", "atom_prob_ml", "atom_gmm_sampl"):
        mod = importlib.import_module(f"pytracking_tpu.parameter.atom.{mod_name}")
        monkeypatch.setattr(mod, "atom_resnet18", lambda *a, **k: "atom_resnet18")
        monkeypatch.setattr(mod, "env_settings", lambda: env)
        monkeypatch.setattr(mod, "load_or_init_variables", lambda *a, **k: {})
    ref = importlib.import_module(f"pytracking_tpu.parameter.atom.{name}").parameters().params
    built = {}
    default = importlib.import_module("pytracking_tpu_torch.parameter.atom.default")
    monkeypatch.setattr(default, "atom_resnet18", lambda **k: built.setdefault("net", k))
    got = importlib.import_module(f"pytracking_tpu_torch.parameter.atom.{name}").parameters(
        device="cpu", seed=3)
    for f in dataclasses.fields(ref):
        assert getattr(got.params, f.name) == getattr(ref, f.name), f.name
    assert built["net"]["device"] == "cpu" and built["net"]["generator"].initial_seed() == 3
    assert not (tmp_path / "absent").exists()
