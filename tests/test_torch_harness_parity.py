"""The port's whole harness against the JAX package's, on the CPU: the tiny
DiMP of tests/test_dimp_tracker.py and the tiny LWL of
tests/test_torch_lwl_ops.py, with the same weights (converted from the JAX
`init`), through `run_dataset` -> result files -> `extract_results` /
`evaluate_vos` on small synthetic datasets (120x160 frames); the entry
points `run_tracker` and `run_experiment` with a stubbed parameter module;
the command line; the bf16 variables' way into the parameter modules; and
the spawned worker pool.

DiMP's parameters draw no random numbers that reach a result (no jitter
boxes, no dropout, random shift 0), and its not-found threshold 0.305 lies
3.8e-4 or more from every peak of the JAX run (0.2984-0.4734). Limits:
result files equal except truncated coordinates within 1e-3 of an
integer (counted, at most 2% of them), AUC / precision within 1e-6 where
the files are equal; segmentation PNGs equal except pixels whose JAX
probability is within 1e-4 of the 0.5 threshold, J and F within 1e-6 where
the PNGs are equal.
"""

import argparse
import importlib
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytracking_tpu.evaluation.environment as j_env
import pytracking_tpu_torch.evaluation.environment as t_env
from pytracking_tpu.analysis import evaluate_vos as j_vos
from pytracking_tpu.analysis import extract_results as j_extract
from pytracking_tpu.analysis import plot_results as j_plot
from pytracking_tpu.evaluation import running as j_running
from pytracking_tpu.evaluation.adapters import synthetic as j_syn
from pytracking_tpu_torch.analysis import evaluate_vos as t_vos
from pytracking_tpu_torch.analysis import extract_results as t_extract
from pytracking_tpu_torch.analysis import plot_results as t_plot
from pytracking_tpu_torch.evaluation import running as t_running
from pytracking_tpu_torch.evaluation.adapters import synthetic as t_syn
from pytracking_tpu_torch.trackers.base import TrackerSpec as TSpec

from test_torch_lwl_ops import one_thread  # noqa: F401 (autouse: one CPU thread)

H, W = 120, 160
DIMP_KW = dict(image_sample_size=96, sample_memory_size=8, net_opt_iter=3,
               net_opt_update_iter=2, net_opt_hn_iter=1,
               augmentation=(("fliplr", True), ("blur", ((2, 1),))), random_shift_factor=0.0,
               num_init_random_boxes=0, box_refinement_iter=2, iounet_k=2, train_skipping=4,
               target_not_found_threshold=0.305)
LWL_KW = dict(image_sample_size=(64, 64), sample_memory_size=4, net_opt_iter=2,
              net_opt_update_iter=1)


@pytest.fixture
def roots(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTRACKING_TPU_ROOT", str(tmp_path / "jax"))
    monkeypatch.setenv("PYTRACKING_TPU_TORCH_ROOT", str(tmp_path / "torch"))
    monkeypatch.setenv("PYTRACKING_TPU_SHAPE_BUCKETS", "0")   # the JAX crop reads the frame
    monkeypatch.setattr(j_env, "_env_settings", None)
    monkeypatch.setattr(t_env, "_env_settings", None)
    return tmp_path


@pytest.fixture(scope="module")
def dimp_nets():
    from test_torch_dimp import _perturb_batch_stats, jax_tiny_dimpnet, torch_tiny_dimpnet

    from pytracking_tpu_torch.utils.convert_weights import dimpnet_from_flax

    jnet = jax_tiny_dimpnet()
    im = jnp.zeros((1, 1, 96, 96, 3))
    bb = jnp.array([[[30.0, 30.0, 20.0, 20.0]]])
    v = jax.jit(lambda k: jnet.init(k, im, im, bb, bb[:, :, None], train=False))(
        jax.random.PRNGKey(0))
    v = _perturb_batch_stats(jax.tree_util.tree_map(np.asarray, dict(v)), 7)
    tnet = torch_tiny_dimpnet()
    tnet.load_state_dict(dimpnet_from_flax(v, tnet))
    return jnet, v, tnet


def _recording(tracker, record):
    """Keep each frame's tracker output (the boxes before the writer's
    truncation, the merged probabilities)."""
    create = tracker.create_tracker

    def create_tracker(multiobj=False):
        t = create(multiobj)
        track = t.track

        def recorded(image, info=None):
            out = track(image, info)
            record.append(out)
            return out

        t.track = recorded
        return t

    tracker.create_tracker = create_tracker
    return tracker


def _trackers(name, param, jspec, tspec):
    from pytracking_tpu.evaluation.tracker import Tracker as JTracker
    from pytracking_tpu_torch.evaluation.tracker import Tracker as TTracker

    jt, tt = JTracker(name, param), TTracker(name, param, device="cpu")
    jt._spec, tt._spec = jspec, tspec
    rec = ([], [])
    return _recording(jt, rec[0]), _recording(tt, rec[1]), rec


def _box_files_agree(jt, tt, names, boxes):
    """Box files equal except truncations of coordinates within 1e-3 of an
    integer; returns (differing entries, entries)."""
    diff = total = 0
    for name in names:
        ref = np.loadtxt(os.path.join(jt.results_dir, name), delimiter="\t", ndmin=2)
        got = np.loadtxt(os.path.join(tt.results_dir, name), delimiter="\t", ndmin=2)
        assert got.shape == ref.shape
        total += ref.size
        bad = got != ref
        diff += int(bad.sum())
        near = np.abs(boxes[name] - np.round(boxes[name])) < 1e-3
        assert np.all(near[bad]) and np.all(np.abs(got - ref)[bad] == 1), name
    return diff, total


def test_whole_harness_dimp_matches_jax(roots, dimp_nets):
    """run_dataset -> files -> extract_results of the tiny DiMP (IoU-Net box
    refinement on): normal and not_found frames."""
    from pytracking_tpu.evaluation.tracker import TrackerSpec as JSpec
    from pytracking_tpu.trackers.dimp import DiMPParams as JParams
    from pytracking_tpu_torch.trackers.dimp import DiMPParams as TParams

    jnet, v, tnet = dimp_nets
    jt, tt, rec = _trackers("dimp", "dimp50", JSpec(JParams(**DIMP_KW), jnet, v),
                            TSpec(TParams(**DIMP_KW), tnet))
    jds = j_syn.SyntheticDataset(2, 10, H, W).get_sequence_list()
    tds = t_syn.SyntheticDataset(2, 10, H, W).get_sequence_list()
    j_running.run_dataset(jds, [jt], debug=1)
    t_running.run_dataset(tds, [tt], debug=1)

    flags = [o["flag"] for o in rec[0]]
    assert [o["flag"] for o in rec[1]] == flags
    assert {"not_found", "normal"} <= set(flags)
    for a, b in zip(*rec):
        np.testing.assert_allclose(b["target_bbox"], a["target_bbox"], atol=1e-3, rtol=0)
    names = [f"{s.name}.txt" for s in tds]
    boxes = {}
    for k, s in enumerate(tds):
        frames = [s.init_info()["init_bbox"]] + [o["target_bbox"] for o in rec[1][9 * k:9 * k + 9]]
        boxes[f"{s.name}.txt"] = np.asarray(frames, np.float64)
    diff, total = _box_files_agree(jt, tt, names, boxes)
    assert diff <= 0.02 * total, (diff, total)
    assert sorted(os.listdir(tt.results_dir)) == sorted(os.listdir(jt.results_dir))

    got = t_extract.extract_results([tt], tds, report_name="rep")
    ref = j_extract.extract_results([jt], jds, report_name="rep")
    gs, rs = t_plot.get_scores(got), j_plot.get_scores(ref)
    tol = 1e-6 if diff == 0 else 1.0
    for k in ("AUC", "Precision", "Norm Precision", "OP50"):
        np.testing.assert_allclose(gs[k], rs[k], atol=tol, rtol=0)
    # either package's analysis reads the other's files
    cross = j_extract.extract_results([tt], jds)
    np.testing.assert_allclose(np.asarray(cross["ave_success_rate_plot_overlap"]),
                               np.asarray(got["ave_success_rate_plot_overlap"]), atol=1e-12)


def test_whole_harness_lwl_matches_jax(roots):
    """run_dataset of the tiny LWL on synthetic_vos through the
    MultiObjectWrapper (LWL's merge) -> PNGs and box files -> evaluate_vos."""
    from test_torch_lwl_ops import tiny_lwl_pair

    from pytracking_tpu.evaluation.tracker import TrackerSpec as JSpec
    from pytracking_tpu.trackers.lwl import LWLParams as JParams
    from pytracking_tpu_torch.trackers.lwl import LWLParams as TParams

    jnet, v, tnet = tiny_lwl_pair()
    jt, tt, rec = _trackers("lwl", "lwl_ytvos", JSpec(JParams(**LWL_KW), jnet, v),
                            TSpec(TParams(**LWL_KW), tnet))
    jds = j_syn.SyntheticVOSDataset(2, 6, H, W).get_sequence_list()
    tds = t_syn.SyntheticVOSDataset(2, 6, H, W).get_sequence_list()
    j_running.run_dataset(jds, [jt], debug=1)
    t_running.run_dataset(tds, [tt], debug=1)

    png_diff = 0
    for a, b in zip(*rec):
        bad = a["segmentation"] != b["segmentation"]
        prob = np.asarray(a["segmentation_raw"]["1"])
        assert np.all(np.abs(prob[bad] - 0.5) < 1e-4)
        png_diff += int(bad.sum())
        np.testing.assert_allclose(b["segmentation_raw"]["1"], prob, atol=1e-4, rtol=0)
        np.testing.assert_allclose(b["target_bbox"]["1"], a["target_bbox"]["1"], atol=1e-3,
                                   rtol=0)
    from pytracking_tpu_torch.utils.png_io import imread_indexed

    for s in tds:
        names = sorted(os.listdir(os.path.join(jt.segmentation_dir, s.name)))
        assert names == [f"{i:05d}.png" for i in range(6)]
        assert sorted(os.listdir(os.path.join(tt.segmentation_dir, s.name))) == names
        if png_diff == 0:
            for n in names:
                np.testing.assert_array_equal(
                    imread_indexed(os.path.join(tt.segmentation_dir, s.name, n)),
                    imread_indexed(os.path.join(jt.segmentation_dir, s.name, n)))
    boxes = {}
    for k, s in enumerate(tds):
        frames = [s.init_info()["init_bbox"]] + [o["target_bbox"]["1"]
                                                 for o in rec[1][5 * k:5 * k + 5]]
        boxes[f"{s.name}_1.txt"] = np.asarray(frames, np.float64)
    diff, total = _box_files_agree(jt, tt, list(boxes), boxes)
    assert diff <= 0.02 * total, (diff, total)
    assert sorted(os.listdir(tt.results_dir)) == sorted(os.listdir(jt.results_dir))

    got = t_vos.evaluate_vos([tt], tds, quiet=True)["lwl_lwl_ytvos"]
    ref = j_vos.evaluate_vos([jt], jds, quiet=True)["lwl_lwl_ytvos"]
    for k in ref:
        assert abs(got[k] - ref[k]) <= (1e-6 if png_diff == 0 else 1e-2), k


def test_lwl_routes_agree(roots, monkeypatch):
    """The tiny LWL on synthetic_vos through the MultiObjectWrapper and,
    under PYTRACKING_TPU_VMAP_MULTIOBJ=1, through LWLMultiObjectTracker,
    both from each mask's extent (the batched class's own box): the same
    PNGs but for pixels within 1e-3 of the threshold."""
    from test_torch_lwl_ops import tiny_lwl_pair

    from pytracking_tpu_torch.evaluation.tracker import Tracker
    from pytracking_tpu_torch.trackers.lwl import LWLParams
    from pytracking_tpu_torch.utils.png_io import imread_indexed

    ds = t_syn.SyntheticVOSDataset(2, 6, H, W).get_sequence_list()
    for seq in ds:
        ys, xs = np.nonzero(seq.ground_truth_seg[0])
        seq.init_data[0]["bbox"] = [float(xs.min()), float(ys.min()),
                                    float(xs.max() - xs.min() + 1), float(ys.max() - ys.min() + 1)]
    spec = TSpec(LWLParams(**LWL_KW), tiny_lwl_pair()[2])
    runs = {}
    for vmap in ("0", "1"):
        monkeypatch.setenv("PYTRACKING_TPU_VMAP_MULTIOBJ", vmap)
        tracker = Tracker("lwl", "lwl_ytvos", run_id=int(vmap), device="cpu")
        tracker._spec = spec
        tracker.segmentation_dir += f"_{vmap}"
        rec = []
        t_running.run_dataset(ds, [_recording(tracker, rec)], debug=1)
        runs[vmap] = (tracker, rec)
    for k, seq in enumerate(ds):
        for t in range(6):
            a, b = (imread_indexed(os.path.join(runs[v][0].segmentation_dir, seq.name,
                                                f"{t:05d}.png")) for v in ("0", "1"))
            bad = a != b
            if t == 0:
                assert not bad.any()
                continue
            out = runs["0"][1][5 * k + t - 1]
            assert type(runs["1"][1][5 * k + t - 1]["segmentation_raw"]).__name__ == "OrderedDict"
            prob = np.asarray(out["segmentation_raw"]["1"])
            assert np.all(np.abs(prob[bad] - 0.5) < 1e-3), (k, t, int(bad.sum()))


# ---------------------------------------------------------------- entry points

@pytest.fixture
def tiny_dimp50(monkeypatch, dimp_nets):
    """`parameter/dimp/dimp50` returns the tiny DiMP; records its kwargs."""
    from pytracking_tpu_torch.parameter.dimp import dimp50
    from pytracking_tpu_torch.trackers.dimp import DiMPParams

    calls = []

    def parameters(device="cuda", **kw):
        calls.append(dict(kw, device=device))
        return TSpec(params=DiMPParams(**DIMP_KW), net=dimp_nets[2])

    monkeypatch.setattr(dimp50, "parameters", parameters)
    return calls


def test_run_tracker_and_run_experiment_end_to_end(roots, tiny_dimp50, capsys):
    from pytracking_tpu_torch import run_experiment, run_tracker
    from pytracking_tpu_torch.analysis.plot_results import print_results
    from pytracking_tpu_torch.evaluation.datasets import get_dataset

    run_tracker.main(["dimp", "dimp50", "--dataset_name", "synthetic", "--sequence",
                      "synthetic_001", "--device", "cpu"])
    results = roots / "torch" / "tracking_results" / "dimp" / "dimp50"
    assert sorted(os.listdir(results)) == ["synthetic_001.txt",
                                           "synthetic_001_object_presence_scores.txt",
                                           "synthetic_001_time.txt"]
    assert tiny_dimp50 == [{"device": torch.device("cpu")}]
    assert np.loadtxt(results / "synthetic_001.txt").shape == (20, 4)

    trackers = run_experiment.run_experiment("myexperiments", "dimp_synthetic", device="cpu")
    assert len(os.listdir(results)) == 9 and "skipping synthetic_001" in capsys.readouterr().out
    scores = print_results(trackers, get_dataset("synthetic"), report_name="exp")
    assert np.isfinite(scores["AUC"]).all() and (roots / "torch" / "result_plots" / "exp"
                                                 / "eval_data.pkl").is_file()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_tracker.run_tracker("dimp", "dimp50")          # the default device is the card
    with pytest.raises(RuntimeError, match="CUDA"):
        run_experiment.run_experiment("myexperiments", "dimp_synthetic")


def _jax_parser(module, argv, monkeypatch):
    """The argparse parser a JAX `main()` builds."""
    seen = {}

    def parse_args(self, args=None, namespace=None):
        seen["parser"] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(SystemExit):
        module.main()
    monkeypatch.undo()
    return seen["parser"]


def _options(parser):
    return {tuple(a.option_strings) or (a.dest,): (a.dest, a.type, a.default)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", ["run_tracker", "run_experiment"])
def test_command_line_matches_jax_plus_device(name, monkeypatch):
    jmod = importlib.import_module(f"pytracking_tpu.{name}")
    tmod = importlib.import_module(f"pytracking_tpu_torch.{name}")
    ref = _options(_jax_parser(jmod, ["x"], monkeypatch))
    got = _options(tmod.parser())
    assert got.pop(("--device",)) == ("device", str, "cuda")
    assert got == ref


# ---------------------------------------------------------------- bf16 variables

JAX_CONSTRUCTORS = ("dimpnet50", "dimpnet18", "klcedimpnet50", "klcedimpnet18",
                    "dimpnet50_simple", "tompnet50", "tompnet101", "tamosnet_resnet50",
                    "tamosnet_swin_base", "steepest_descent_resnet50",
                    "steepest_descent_resnet50_boxinit", "rts50", "atom_resnet18",
                    "kysnet_res50", "target_candidate_matching_net_resnet50", "mobilenet3")
PORT_CONSTRUCTORS = JAX_CONSTRUCTORS + ("sta_resnet50", "resnet18_vggmconv1")
MODES = {"f32": {}, "bf16": {"PYTRACKING_TPU_BF16": "1"},
         "backbone": {"PYTRACKING_TPU_BF16_BACKBONE": "1"},
         "both": {"PYTRACKING_TPU_BF16": "1", "PYTRACKING_TPU_BF16_BACKBONE": "1"}}


def _parameter_modules():
    root = os.path.join(os.path.dirname(os.path.dirname(__file__)), "pytracking_tpu",
                        "parameter")
    return sorted(f"{d}/{f[:-3]}" for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d)) and d != "__pycache__"
                  for f in os.listdir(os.path.join(root, d))
                  if f.endswith(".py") and f != "__init__.py")


def _net_stub(kwargs):
    net = mock.MagicMock()
    net.bf16 = {("backbone_dtype" if k == "dtype" else k) for k, v in kwargs.items()
                if v in (jnp.bfloat16, torch.bfloat16)}
    net.init.return_value = {"params": {"w": np.zeros(2, np.float32)}, "batch_stats": {}}
    return net


def _observe_jax(module, monkeypatch, network_path):
    """The bf16 parts of the net the JAX module returns: its constructor's
    bf16 dtypes and whether its variables are stored bf16."""
    import types

    import pytracking_tpu.models.backbones.vggm_resnet as vggm

    mod = importlib.import_module(f"pytracking_tpu.parameter.{module.replace('/', '.')}")
    patched = [mod] + [importlib.import_module(f"pytracking_tpu.parameter.{m}")
                       for m in ("dimp.dimp50", "dimp.dimp18", "dimp.prdimp50", "eco.default",
                                 "dimp.dimp50_vot18", "atom.default", "kys.default",
                                 "keep_track.default")]
    env = types.SimpleNamespace(network_path=str(network_path))
    for m in patched:
        for name in JAX_CONSTRUCTORS:
            if hasattr(m, name):
                monkeypatch.setattr(m, name, lambda *a, **k: _net_stub(k))
        if hasattr(m, "_ECOBackbone"):
            monkeypatch.setattr(m, "_ECOBackbone", lambda fe: fe)
        if hasattr(m, "env_settings"):
            monkeypatch.setattr(m, "env_settings", lambda: env)
        if hasattr(m, "load_or_init_variables"):
            monkeypatch.setattr(m, "load_or_init_variables",
                                lambda *a, **k: {"params": {"w": np.zeros(2, np.float32)}})
    monkeypatch.setattr(vggm, "resnet18_vggmconv1", lambda *a, **k: _net_stub(k))
    spec = mod.parameters()
    leaves = jax.tree_util.tree_leaves(spec.variables)
    weights = any(getattr(x, "dtype", None) == jnp.bfloat16 for x in leaves)
    return spec.net.bf16 | ({"weights"} if weights else set())


def _observe_port(module, monkeypatch):
    """The same of the port's `Tracker(...).get_parameters()`."""
    from pytracking_tpu_torch.evaluation.tracker import Tracker

    rounded = []
    root = os.path.join(os.path.dirname(os.path.dirname(__file__)), "pytracking_tpu_torch",
                        "parameter")
    for m in _parameter_modules():
        assert os.path.isfile(os.path.join(root, m + ".py")), m
        pm = importlib.import_module(f"pytracking_tpu_torch.parameter.{m.replace('/', '.')}")
        for name in PORT_CONSTRUCTORS:
            if hasattr(pm, name):
                monkeypatch.setattr(pm, name, lambda *a, **k: _net_stub(k))
        for name, fn in (("eco_backbone", lambda fe, *a, **k: fe),
                         ("round_to_bf16_", lambda net: rounded.append(net) or net)):
            if hasattr(pm, name):
                monkeypatch.setattr(pm, name, fn)
    name, param = module.split("/")
    spec = Tracker(name, param, device="cpu").get_parameters()
    return spec.net.bf16 | ({"weights"} if any(n is spec.net for n in rounded) else set())


@pytest.mark.parametrize("mode", list(MODES))
def test_bf16_variables_reach_the_parameter_modules_as_in_jax(mode, monkeypatch, tmp_path):
    """Under each setting of PYTRACKING_TPU_BF16 / _BF16_BACKBONE, every
    parameter module's net has the bf16 backbone, bf16 transformer and
    bf16-stored weights exactly where the JAX module's does (net
    constructors, variables and the weight rounding stubbed)."""
    for module in _parameter_modules():     # imported before any patch: a module
        for pkg in ("pytracking_tpu", "pytracking_tpu_torch"):   # binds names at import
            importlib.import_module(f"{pkg}.parameter.{module.replace('/', '.')}")
    for var in ("PYTRACKING_TPU_BF16", "PYTRACKING_TPU_BF16_BACKBONE"):
        monkeypatch.delenv(var, raising=False)
    for var, value in MODES[mode].items():
        monkeypatch.setenv(var, value)
    seen = {}
    for module in _parameter_modules():
        with monkeypatch.context() as mp:
            ref = _observe_jax(module, mp, tmp_path / "absent")
        with monkeypatch.context() as mp:
            got = _observe_port(module, mp)
        assert got == ref, (module, got, ref)
        seen[module] = got
    expect = {"f32": set(), "bf16": {"dimp/dimp50", "tomp/tomp50", "tamos/tamos_resnet50",
                                     "lwl/lwl_ytvos", "rts/rts50", "eco/default",
                                     "tamos/tamos_swin_base"},
              "backbone": {"dimp/dimp50", "tomp/tomp101", "eco/default"}}
    assert expect.get(mode, set()) <= {m for m, s in seen.items() if s}


# ---------------------------------------------------------------- worker pool

def test_spawned_pool_writes_the_threads0_files(roots, monkeypatch):
    """threads = 1: a spawned worker rebuilds DiMP-18 (its parameter module,
    on the CPU) and writes the files of an in-process run."""
    from pytracking_tpu_torch.evaluation.tracker import Tracker

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ds = t_syn.SyntheticDataset(1, 4, H, W).get_sequence_list()
    inproc = Tracker("dimp", "dimp18", run_id=0, device="cpu")
    pooled = Tracker("dimp", "dimp18", run_id=1, device="cpu")
    assert t_running.run_dataset(ds, [inproc], debug=1) is None
    reports = t_running.run_dataset(ds, [pooled], debug=1, threads=1)
    assert len(reports) == 1 and reports[0][1:] == ("synthetic_000", None)
    assert reports[0][0] != os.getpid()
    for f in ("synthetic_000.txt", "synthetic_000_object_presence_scores.txt"):
        assert (open(os.path.join(pooled.results_dir, f)).read()
                == open(os.path.join(inproc.results_dir, f)).read()), f
    assert np.loadtxt(os.path.join(pooled.results_dir, "synthetic_000_time.txt")).shape == (4,)
