"""The port stands alone: pytracking_tpu_torch (its evaluation harness and
entry points included), chip_smoke.py and the port's
own scripts (scripts/dimp_check.py, scripts/k1_check.py,
scripts/tomp_check.py, scripts/kys_check.py, scripts/keep_track_check.py,
scripts/lwl_check.py, scripts/atom_eco_check.py, scripts/serving_check.py,
scripts/train_check.py, scripts/checkpoint_check.py) import no JAX, no
flax and nothing of the JAX package (the dataset adapters, the VOT entry,
the result packers, the training dataset readers and the distractor dump
among them), the VOT toolkit's manifests in
pytracking_tpu_torch/VOT/ name only the port, and the port's entry points
refuse to run on a CUDA device that is absent instead of falling back to the
CPU."""

import ast
import importlib
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pytracking_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pytracking_tpu")
PORT_SCRIPTS = ("dimp_check.py", "k1_check.py", "tomp_check.py", "kys_check.py",
                "keep_track_check.py", "lwl_check.py", "atom_eco_check.py", "serving_check.py",
                "train_check.py", "checkpoint_check.py")


def _port_sources():
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    for script in PORT_SCRIPTS:
        yield os.path.join(REPO, "scripts", script)


def _port_modules():
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        if rel.startswith("pytracking_tpu_torch"):
            yield rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", list(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports_in_port_sources(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{os.path.relpath(path, REPO)} imports {name}"


# the training dataset readers, their tree writer and the distractor dump
TRAINING_DATA_MODULES = tuple(
    f"pytracking_tpu_torch.training.datasets.{m}" for m in (
        "lasot", "got10k", "tracking_net", "coco_seq", "imagenetvid", "mot_datasets",
        "tao_burst", "vos_base", "vos_wrappers", "seg_images", "synthetic_video_blend",
        "candidate_matching", "training_trees")) + (
    "pytracking_tpu_torch.util_scripts.create_distractor_dataset",)


def test_training_data_modules_are_checked():
    """Each of them is among the modules the two tests above read and
    import with JAX blocked."""
    assert set(TRAINING_DATA_MODULES) <= set(_port_modules())


def test_distractor_dump_raises_without_cuda(tmp_path, monkeypatch):
    """`run_tracker` of the distractor dump (also from the command line)
    defaults to the card and refuses to run without one, before it writes
    anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal only shows without one")
    from pytracking_tpu_torch.evaluation import environment
    from pytracking_tpu_torch.util_scripts import create_distractor_dataset as cdd

    monkeypatch.setenv("PYTRACKING_TPU_TORCH_ROOT", str(tmp_path / "root"))
    environment.reset_env_settings()
    save_dir = tmp_path / "dump"
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            cdd.run_tracker("dimp", "super_dimp", "lasot_train", str(save_dir))
        with pytest.raises(RuntimeError, match="CUDA"):
            cdd.main(["dimp", "super_dimp", "lasot_train", str(save_dir)])
    finally:
        environment.reset_env_settings()
    assert not save_dir.exists()


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(PKG, "VOT"))))
def test_vot_manifests_name_only_the_port(name):
    """The toolkit's manifests start the port's entry, never the JAX
    package's."""
    import re

    text = open(os.path.join(PKG, "VOT", name)).read()
    assert re.findall(r"pytracking_tpu(?!_torch)\b", text) == [], name
    assert "pytracking_tpu_torch" in text and "run_vot" in text


def test_every_port_module_imports_with_jax_blocked():
    modules = list(_port_modules())
    code = "\n".join([
        "import sys",
        f"for name in {FORBIDDEN!r}:",
        "    sys.modules[name] = None",
        "import importlib",
        f"for m in {modules!r}:",
        "    importlib.import_module(m)",
        "leaked = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None]",
        "assert not leaked, leaked",
        "print('imported', len(" + repr(modules) + "))",
    ])
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(modules)}" in res.stdout


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal only shows without one")
    from pytracking_tpu_torch.models.tracking import dimpnet
    from pytracking_tpu_torch.models.tracking.dimpnet import dimpnet50
    from pytracking_tpu_torch.models.tracking.tamosnet import tamosnet_resnet50
    from pytracking_tpu_torch.parameter.dimp import dimp50
    from pytracking_tpu_torch.parameter.tamos import tamos_resnet50
    from pytracking_tpu_torch.trackers.dimp import DiMPParams, DiMPTracker
    from pytracking_tpu_torch.trackers.tamos import TaMOsParams, TaMOsTracker
    from pytracking_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        tamos_resnet50.parameters()
    with pytest.raises(RuntimeError, match="CUDA"):
        tamos_resnet50.parameters(device="cuda", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tamosnet_resnet50(num_encoder_layers=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TaMOsTracker(TaMOsParams(), torch.nn.Linear(1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        dimp50.parameters()
    with pytest.raises(RuntimeError, match="CUDA"):
        dimp50.parameters(device="cuda", seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        dimpnet50()
    with pytest.raises(RuntimeError, match="CUDA"):
        DiMPTracker(DiMPParams(), torch.nn.Linear(1, 1))
    for name in ("dimpnet18", "klcedimpnet50", "klcedimpnet18", "dimpnet50_simple"):
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(dimpnet, name)()
    for module in ("dimp.dimp18", "dimp.prdimp18", "dimp.prdimp50", "dimp.super_dimp",
                   "dimp.dimp50_vot18", "dimp.dimp50_vot19", "dimp.dimp18_vot18",
                   "dimp.prdimp50_vot18", "dimp_simple.super_dimp_simple"):
        with pytest.raises(RuntimeError, match="CUDA"):
            importlib.import_module(f"pytracking_tpu_torch.parameter.{module}").parameters()
    from pytracking_tpu_torch.models.tracking import tompnet
    from pytracking_tpu_torch.models.tracking.tamosnet import tamosnet_swin_base
    from pytracking_tpu_torch.trackers.tomp import ToMPParams, ToMPTracker

    for name in ("tompnet50", "tompnet101"):
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(tompnet, name)()
    with pytest.raises(RuntimeError, match="CUDA"):
        tamosnet_swin_base()
    with pytest.raises(RuntimeError, match="CUDA"):
        ToMPTracker(ToMPParams(), torch.nn.Linear(1, 1))
    for module in ("tomp.tomp50", "tomp.tomp101", "tamos.tamos_swin_base"):
        mod = importlib.import_module(f"pytracking_tpu_torch.parameter.{module}")
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.parameters()
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.parameters(device="cuda", dtype=torch.bfloat16)
    from pytracking_tpu_torch.models.tcm.target_candidate_matching import \
        target_candidate_matching_net_resnet50
    from pytracking_tpu_torch.models.tracking.kysnet import kysnet_res50
    from pytracking_tpu_torch.trackers.keep_track import KeepTrackParams, KeepTrackTracker
    from pytracking_tpu_torch.trackers.kys import KYSParams, KYSTracker

    with pytest.raises(RuntimeError, match="CUDA"):
        kysnet_res50()
    with pytest.raises(RuntimeError, match="CUDA"):
        target_candidate_matching_net_resnet50()
    with pytest.raises(RuntimeError, match="CUDA"):
        KYSTracker(KYSParams(), torch.nn.Linear(1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        KeepTrackTracker(KeepTrackParams(), torch.nn.Linear(1, 1), torch.nn.Linear(1, 1))
    for module in ("kys.default", "kys.default_vot", "keep_track.default",
                   "keep_track.default_fast"):
        mod = importlib.import_module(f"pytracking_tpu_torch.parameter.{module}")
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.parameters()
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.parameters(device="cuda", seed=1)
    from pytracking_tpu_torch.models.lwl.lwl_net import (steepest_descent_resnet50,
                                                         steepest_descent_resnet50_boxinit)
    from pytracking_tpu_torch.models.lwl.sta_net import sta_resnet50
    from pytracking_tpu_torch.models.rts.rts_net import rts50
    from pytracking_tpu_torch.trackers.lwl import LWLMultiObjectTracker, LWLParams, LWLTracker
    from pytracking_tpu_torch.trackers.rts import RTSParams, RTSTracker

    for ctor in (steepest_descent_resnet50, steepest_descent_resnet50_boxinit, sta_resnet50,
                 rts50):
        with pytest.raises(RuntimeError, match="CUDA"):
            ctor()
    for cls, params in ((LWLTracker, LWLParams()), (LWLMultiObjectTracker, LWLParams()),
                        (RTSTracker, RTSParams())):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(params, torch.nn.Linear(1, 1))
    for module in ("lwl.lwl_ytvos", "lwl.lwl_boxinit", "rts.rts50"):
        mod = importlib.import_module(f"pytracking_tpu_torch.parameter.{module}")
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.parameters()
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.parameters(device="cuda", seed=1, weights_bf16=True)
    assert resolve_device("cpu") == torch.device("cpu")


def test_atom_eco_entry_points_raise_without_cuda():
    """ATOM's and ECO's nets, trackers and parameter modules, and DiMP-50's
    bf16 options, default to the card and refuse to run without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal only shows without one")
    from pytracking_tpu_torch.models.tracking.atomnet import atom_resnet18, atom_resnet50
    from pytracking_tpu_torch.parameter.dimp import dimp50
    from pytracking_tpu_torch.parameter.eco.default import eco_backbone
    from pytracking_tpu_torch.trackers.atom import ATOMParams, ATOMTracker
    from pytracking_tpu_torch.trackers.eco import ECOParams, ECOTracker

    for ctor in (atom_resnet18, atom_resnet50, lambda: eco_backbone(torch.nn.Identity())):
        with pytest.raises(RuntimeError, match="CUDA"):
            ctor()
    for cls, params in ((ATOMTracker, ATOMParams()), (ECOTracker, ECOParams())):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(params, torch.nn.Linear(1, 1))
    for module in ("atom.default", "atom.default_vot", "atom.atom_prob_ml",
                   "atom.atom_gmm_sampl", "atom.multiscale_no_iounet", "eco.default",
                   "eco.mobile3"):
        mod = importlib.import_module(f"pytracking_tpu_torch.parameter.{module}")
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.parameters()
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.parameters(device="cuda", seed=1)
    for kw in (dict(dtype=torch.bfloat16), dict(backbone_dtype=torch.bfloat16)):
        with pytest.raises(RuntimeError, match="CUDA"):
            dimp50.parameters(**kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        importlib.import_module("pytracking_tpu_torch.parameter.eco.default").parameters(
            backbone_dtype=torch.bfloat16)


def test_serving_entry_points_raise_without_cuda(monkeypatch):
    """The batched server defaults to the card and refuses to run without
    one, with the bf16 default and without it; so does the launch count
    of scripts/serving_check.py unless it is asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal only shows without one")
    from pytracking_tpu_torch.parallel.serving import BatchedTrackerServer
    from pytracking_tpu_torch.trackers.dimp import DiMPParams, DiMPTracker

    for kw in ({}, dict(bf16=False), dict(bf16=True), dict(device="cuda:0")):
        with pytest.raises(RuntimeError, match="CUDA"):
            BatchedTrackerServer(DiMPTracker, DiMPParams(), torch.nn.Linear(1, 1), **kw)
    monkeypatch.setenv("PYTRACKING_TPU_SERVING_BF16", "0")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedTrackerServer(DiMPTracker, DiMPParams(), torch.nn.Linear(1, 1))
    res = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "serving_check.py"),
                          "launches"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "CUDA" in res.stderr


def test_harness_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    """The harness's entry points default to the card and refuse to run
    without one: `Tracker`, `run_tracker` and `run_experiment` (also from
    the command line), before any sequence is tracked (the harness skips a
    sequence that raises, so a CPU fallback there would go unnoticed)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal only shows without one")
    from pytracking_tpu_torch import run_experiment, run_tracker
    from pytracking_tpu_torch.evaluation import environment
    from pytracking_tpu_torch.evaluation.tracker import Tracker

    monkeypatch.setenv("PYTRACKING_TPU_TORCH_ROOT", str(tmp_path))
    environment.reset_env_settings()
    for name, param in (("dimp", "dimp50"), ("tamos", "tamos_resnet50"), ("lwl", "lwl_ytvos")):
        with pytest.raises(RuntimeError, match="CUDA"):
            Tracker(name, param)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_tracker.run_tracker("dimp", "dimp50", dataset_name="synthetic")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_tracker.main(["dimp", "dimp50", "--dataset_name", "synthetic"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_experiment.run_experiment("myexperiments", "dimp_synthetic")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_experiment.main(["myexperiments", "dimp_synthetic"])
    assert not os.listdir(tmp_path)
    environment.reset_env_settings()


def test_vot_entry_points_raise_without_cuda():
    """`run_vot2020` / `run_vot` (also from the command line) refuse to run
    without a card before the TraX handshake: the toolkit's session serves
    no frame."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal only shows without one")
    from pytracking_tpu_torch import run_vot
    from pytracking_tpu_torch.evaluation import trax_replay

    calls = ((run_vot.run_vot2020, ("dimp", "dimp50")), (run_vot.run_vot, ("dimp", "dimp50")),
             (run_vot.main, (["dimp", "dimp50"],)),
             (run_vot.main, (["dimp", "dimp50", "--protocol", "vot"],)))
    for fn, args in calls:
        with trax_replay.replay(["frame.jpg"], trax_replay.polygon([0, 0, 4, 0, 4, 4, 0, 4])) \
                as session:
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(*args)
        assert session.served == 0


TRAIN_RECIPES = (("dimp", "dimp50"), ("dimp", "dimp18"), ("dimp", "prdimp50"),
                 ("dimp", "prdimp18"), ("dimp", "super_dimp"), ("dimp", "super_dimp_simple"),
                 ("bbreg", "atom"), ("bbreg", "atom_paper"), ("bbreg", "atom_prob_ml"),
                 ("bbreg", "atom_gmm_sampl"), ("tomp", "tomp50"), ("tomp", "tomp101"),
                 ("tamos", "tamos_resnet50"), ("tamos", "tamos_swin_base"),
                 ("lwl", "lwl_stage1"), ("lwl", "lwl_stage2"), ("lwl", "lwl_boxinit"),
                 ("rts", "rts50"), ("kys", "kys"), ("keep_track", "keep_track"))


def test_training_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    """`run_training` (also from the command line), every recipe's `run`
    and its net builder default to the card and refuse to run without one,
    before they write anything to the workspace."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal only shows without one")
    from pytracking_tpu_torch import run_training
    from pytracking_tpu_torch.training.settings import Settings
    from pytracking_tpu_torch.training.train_settings.dimp import dimp50

    monkeypatch.setenv("PYTRACKING_TPU_TORCH_WORKSPACE", str(tmp_path))
    for module, name in TRAIN_RECIPES:
        with pytest.raises(RuntimeError, match="CUDA"):
            run_training.run_training(module, name, max_epochs=1, samples_per_epoch=8)
        with pytest.raises(RuntimeError, match="CUDA"):
            run_training.main([module, name, "--max_epochs", "1"])
        recipe = importlib.import_module(
            f"pytracking_tpu_torch.training.train_settings.{module}.{name}")
        with pytest.raises(RuntimeError, match="CUDA"):
            recipe.run(Settings(), max_epochs=1, samples_per_epoch=8, net=torch.nn.Linear(1, 1))
        with pytest.raises(RuntimeError, match="CUDA"):
            recipe.make_net(Settings())
    with pytest.raises(RuntimeError, match="CUDA"):
        dimp50.run(Settings(), max_epochs=1, samples_per_epoch=8, net=torch.nn.Linear(1, 1))
    assert Settings().workspace_dir == str(tmp_path)
    assert not os.listdir(tmp_path)


def test_chip_smoke_fails_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a card,
    and also when it stands alone in a directory without the package."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    src = os.path.join(REPO, "chip_smoke.py")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(src).read())
    for script, cwd in ((src, REPO), (str(lone), str(tmp_path))):
        res = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode != 0, res.stdout
        assert '"ok": true' not in res.stdout


def test_network_loading_raises_without_cuda(tmp_path, monkeypatch):
    """`load_network` defaults to the card and refuses to run without one,
    before it reads the file; so does a parameter module that finds its
    network file."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal only shows without one")
    from pytracking_tpu_torch.evaluation import environment
    from pytracking_tpu_torch.models.tracking.atomnet import atom_resnet18
    from pytracking_tpu_torch.parameter.atom import default
    from pytracking_tpu_torch.utils.loading import load_network, save_network

    net = atom_resnet18(device="cpu")
    path = str(tmp_path / "atom_default.pth")
    save_network(path, net.state_dict(), "pytracking_tpu_torch.models.tracking.atomnet",
                 "atom_resnet18", {})
    assert load_network(path, device="cpu").state_dict().keys() == net.state_dict().keys()
    with open(path, "wb") as f:
        f.write(b"unread")                     # the device is refused first
    with pytest.raises(RuntimeError, match="CUDA"):
        load_network(path)
    monkeypatch.setenv("PYTRACKING_TPU_TORCH_NETWORK_PATH", str(tmp_path))
    environment.reset_env_settings()
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            default.parameters()
    finally:
        environment.reset_env_settings()
