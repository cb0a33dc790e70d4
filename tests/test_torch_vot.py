"""The port's VOT toolkit entry and result packers against the JAX
package's, on the CPU, without the toolkit and without a network.

A stand-in of the `trax` module (`evaluation/trax_replay.py`) serves a
VOT-layout sequence's frames to both packages' `run_vot2020` (mask
protocol) and `run_vot` (polygon protocol), each driving the same
deterministic stub tracker (its boxes and masks are functions of the
decoded frame) patched into both `Tracker`s: the reported regions and
properties are equal. `convert_vot_anno_to_rect` and `make_full_size` are
held to the JAX functions exactly; both packers' archives hold the same
file names and bytes as the JAX packers' on the same result files.
"""

import os
import zipfile

import numpy as np
import pytest

import pytracking_tpu.evaluation.environment as j_env
import pytracking_tpu_torch.evaluation.environment as t_env
from pytracking_tpu.evaluation import tracker as j_tracker
from pytracking_tpu.evaluation import vot as j_vot
from pytracking_tpu.utils.convert_vot_anno import convert_vot_anno_to_rect as j_convert
from pytracking_tpu_torch import run_vot as t_run_vot
from pytracking_tpu_torch.evaluation import benchmark_trees, trax_replay
from pytracking_tpu_torch.evaluation import tracker as t_tracker
from pytracking_tpu_torch.evaluation import vot as t_vot
from pytracking_tpu_torch.utils.convert_vot_anno import convert_vot_anno_to_rect as t_convert


@pytest.fixture(scope="module")
def vot_sequence(tmp_path_factory):
    """The written VOT tree's polygon sequence (ants1, 6 frames of 32x24)."""
    root = tmp_path_factory.mktemp("benchmarks")
    paths = benchmark_trees.write_benchmark_trees(str(root), size=(32, 24),
                                                  tracked={"vot": 6})
    seq_dir = os.path.join(paths["vot_path"], "ants1")
    frames = sorted(os.path.join(seq_dir, "color", f)
                    for f in os.listdir(os.path.join(seq_dir, "color")))
    polygons = np.loadtxt(os.path.join(seq_dir, "groundtruth.txt"), delimiter=",", ndmin=2)
    return frames, polygons


class StubTracker:
    """Boxes and masks computed from the frame's bytes: the brightest
    column and row move the box; `mode` 'mask' reports a segmentation,
    'box' a box with a presence score."""

    def __init__(self, mode):
        self.mode = mode

    def initialize(self, image, info):
        self.box = np.asarray(info["init_bbox"], np.float64)
        self.init_keys = sorted(info)
        self.mask_sum = int(np.asarray(info.get("init_mask", 0)).sum())

    def track(self, image, info=None):
        g = image.astype(np.float64).mean(axis=2)
        dx = float(np.argmax(g.sum(axis=0))) / g.shape[1] - 0.5
        dy = float(np.argmax(g.sum(axis=1))) / g.shape[0] - 0.5
        self.box = self.box + [dx, dy, 0.25 * dx, 0.25 * dy]
        out = {"target_bbox": self.box.tolist(),
               "object_presence_score": float(g.mean() / 255.0)}
        if self.mode == "mask":
            out["segmentation"] = (g > g.mean()).astype(np.uint8)
        return out


class _Params:
    def __init__(self, conversion):
        if conversion is not None:
            self.vot_anno_conversion_type = conversion


def _patch_trackers(monkeypatch, mode, conversion=None):
    """Both packages' Tracker build the stub; returns the stubs built."""
    built = []

    def create_tracker(self, multiobj=False):
        built.append(StubTracker(mode))
        return built[-1]

    def get_parameters(self):
        return type("Spec", (), {"params": _Params(conversion)})()

    for module in (j_tracker, t_tracker):
        monkeypatch.setattr(module.Tracker, "create_tracker", create_tracker)
        monkeypatch.setattr(module.Tracker, "get_parameters", get_parameters)
    return built


@pytest.fixture
def roots(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTRACKING_TPU_ROOT", str(tmp_path / "jax"))
    monkeypatch.setenv("PYTRACKING_TPU_TORCH_ROOT", str(tmp_path / "torch"))
    monkeypatch.setattr(j_env, "_env_settings", None)
    t_env.reset_env_settings()
    yield tmp_path
    t_env.reset_env_settings()


def _same_reports(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.kind == r.kind and g.properties == r.properties
        a, b = np.asarray(g.region), np.asarray(r.region)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _first_mask(frames, polygons, crop):
    """The first region as the toolkit sends a mask: the polygon's box
    rasterised, stored only as far as its extent (or cropped) so that the
    client pads it to the frame."""
    x, y, w, h = j_convert(polygons[0], "union")
    H, W = 24, 32
    m = np.zeros((H, W), np.uint8)
    m[int(max(y, 0)): int(min(y + h, H)), int(max(x, 0)): int(min(x + w, W))] = 1
    ys, xs = np.nonzero(m)
    m = m[: ys.max() + 1, : xs.max() + 1]
    return m[:, : crop] if crop else m


@pytest.mark.parametrize("mode,crop", [("mask", None), ("box", None), ("mask", 5)])
def test_run_vot2020_reports_match_jax(mode, crop, vot_sequence, roots, monkeypatch):
    frames, polygons = vot_sequence
    region = trax_replay.mask(_first_mask(frames, polygons, crop))
    reports = {}
    for name, entry in (("jax", j_vot.run_vot2020), ("torch", t_vot.run_vot2020)):
        built = _patch_trackers(monkeypatch, mode)
        kw = {"device": "cpu"} if name == "torch" else {}
        with trax_replay.replay(frames, region) as session:
            entry("dimp", "dimp50", **kw)
        assert session.served == len(frames)
        reports[name] = session.reports
        assert len(built) == 1 and built[0].init_keys == ["init_bbox", "init_mask", "object_ids"]
        assert built[0].mask_sum == int(region.array().sum())
    # the echo of the first region, then one report per frame after it
    assert len(reports["torch"]) == len(frames)
    assert reports["torch"][1].kind == ("mask" if mode == "mask" else "rectangle")
    if mode == "box":
        assert set(reports["torch"][1].properties) == {"confidence"}
    _same_reports(reports["torch"], reports["jax"])


@pytest.mark.parametrize("conversion", [None, "union", "preserve_area"])
def test_run_vot_reports_match_jax(conversion, vot_sequence, roots, monkeypatch):
    frames, polygons = vot_sequence
    region = trax_replay.polygon(polygons[0])
    reports = {}
    for name, entry in (("jax", j_vot.run_vot), ("torch", t_vot.run_vot)):
        built = _patch_trackers(monkeypatch, "box", conversion)
        kw = {"device": "cpu"} if name == "torch" else {}
        with trax_replay.replay(frames, region) as session:
            entry("dimp", "dimp50", **kw)
        reports[name] = session.reports
        assert len(built) == 1
    assert len(reports["torch"]) == len(frames)
    assert [r.kind for r in reports["torch"]] == ["polygon"] + ["rectangle"] * (len(frames) - 1)
    _same_reports(reports["torch"], reports["jax"])


def test_run_vot_command_line(vot_sequence, roots, monkeypatch):
    """`python -m pytracking_tpu_torch.run_vot` parses its protocol and
    device and reports a region per frame; the replay ends quietly."""
    frames, polygons = vot_sequence
    for protocol, region in (("vot", trax_replay.polygon(polygons[0])),
                             ("vot2020", trax_replay.mask(_first_mask(frames, polygons, None)))):
        _patch_trackers(monkeypatch, "box")
        with trax_replay.replay(frames, region) as session:
            t_run_vot.main(["dimp", "dimp50", "--protocol", protocol, "--device", "cpu"])
        assert len(session.reports) == len(frames)
        assert session.served == len(frames)
    import sys
    assert "trax" not in sys.modules or sys.modules["trax"] is not trax_replay
    with pytest.raises(ValueError, match="asks for"):
        with trax_replay.replay(frames, trax_replay.rectangle(1, 2, 3, 4)):
            t_run_vot.run_vot2020("dimp", "dimp50", device="cpu")


def test_convert_vot_anno_matches_jax():
    rng = np.random.RandomState(0)
    cases = [rng.rand(8) * 100 for _ in range(20)]
    cases += [benchmark_trees.rotated_polygons([[10, 5, 20, 12]], a)[0]
              for a in (0.0, 0.3, 1.2, -0.7)]
    cases += [np.array([3.0, 4.0, 5.0, 6.0]), np.array([1.0, 1, 1, 1, 1, 1, 1, 1]),
              rng.rand(12) * 50, [[1.5, 2.0], [8.0, 2.5], [7.0, 9.0], [2.0, 8.5]]]
    for poly in cases:
        for kind in ("preserve_area", "union", "other"):
            got, ref = t_convert(poly, kind), j_convert(poly, kind)
            assert len(got) == len(ref) == 4
            assert [type(v) for v in got] == [type(v) for v in ref]
            np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("shape,size", [((24, 32), (32, 24)), ((10, 7), (32, 24)),
                                        ((30, 40), (32, 24)), ((30, 7), (32, 24)),
                                        ((5, 40), (32, 24)), ((0, 0), (8, 6))])
def test_make_full_size_matches_jax(shape, size):
    m = (np.random.RandomState(1).rand(*shape) > 0.5).astype(np.uint8)
    got, ref = t_vot.make_full_size(m, size), j_vot.make_full_size(m, size)
    assert got.shape == ref.shape == (size[1], size[0]) and got.dtype == ref.dtype
    assert got.tobytes() == ref.tobytes()


def _write_results(results_path, tracker, param, names, run_ids, rng):
    for run_id in run_ids:
        d = os.path.join(results_path, tracker,
                         param if run_id is None else f"{param}_{run_id:03d}")
        os.makedirs(d, exist_ok=True)
        for name in names:
            n = rng.randint(2, 6)
            np.savetxt(os.path.join(d, f"{name}.txt"),
                       (rng.rand(n, 4) * 300).astype(int), delimiter="\t", fmt="%d")
            np.savetxt(os.path.join(d, f"{name}_time.txt"), rng.rand(n), delimiter="\t",
                       fmt="%f")


def _zip_contents(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


def _pack_both(roots, packer, args, results):
    """Write the same result files under both roots, run both packers;
    returns the port's and the JAX package's zip contents."""
    import importlib

    out = {}
    for pkg, root in (("pytracking_tpu", "jax"), ("pytracking_tpu_torch", "torch")):
        results(os.path.join(str(roots / root), "tracking_results"))
        mod = importlib.import_module(f"{pkg}.util_scripts.{packer}")
        getattr(mod, packer)(*args)
        packed = os.path.join(str(roots / root), "tracking_results",
                              packer.split("_")[1] + "_packed", args[2] or args[1])
        assert not os.path.exists(packed), "the packer leaves only the zip"
        out[pkg] = _zip_contents(packed + ".zip")
    return out["pytracking_tpu_torch"], out["pytracking_tpu"]


def test_pack_got10k_results_matches_jax(roots):
    names = [f"GOT-10k_Test_{i:06d}" for i in range(1, 181)]
    got, ref = _pack_both(
        roots, "pack_got10k_results", ("dimp", "dimp50", "dimp50_got"),
        lambda p: _write_results(p, "dimp", "dimp50", names, (None, 1, 2),
                                 np.random.RandomState(2)))
    assert list(got) == list(ref) and len(got) >= 180 * 4
    assert all(got[n] == ref[n] for n in ref)
    assert "GOT-10k_Test_000007/GOT-10k_Test_000007_003.txt" in got


@pytest.mark.parametrize("output_name", [None, "submission"])
def test_pack_trackingnet_results_matches_jax(output_name, roots):
    names = ["-3TIfnTSM6c_2", "0-6LB4FqxoE_0", "zz_last"]
    got, ref = _pack_both(
        roots, "pack_trackingnet_results", ("dimp", "dimp50", output_name),
        lambda p: _write_results(p, "dimp", "dimp50", names, (None,),
                                 np.random.RandomState(3)))
    assert list(got) == list(ref) == sorted(f"{n}.txt" for n in names)
    assert all(got[n] == ref[n] for n in ref)
