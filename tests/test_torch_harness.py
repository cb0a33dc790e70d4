"""The port's evaluation harness against the JAX package's, on the CPU, with
trackers of fixed outputs (no nets): the synthetic datasets, the result
files of `run_sequence`, skip-if-done and the two result roots, the
analysis (IoU, the robust per-frame errors, the `extract_results` pickle,
J and F, the per-attribute table), the multi-object wrapper's merge, the
`multiobj_mode` routing, the dataset registry, PNG IO and the worker
pool's plumbing.

Limits: frames, masks and text result files byte for byte (timing files:
the same rows); segmentation PNGs the same array and palette (PIL's zlib
blocks may differ from the port's); analysis arrays within 1e-12; J and F
equal.
"""

import os
import pickle
from collections import OrderedDict

import numpy as np
import pytest

import pytracking_tpu.evaluation.environment as j_env
import pytracking_tpu_torch.evaluation.environment as t_env
from pytracking_tpu.analysis import evaluate_vos as j_vos
from pytracking_tpu.analysis import extract_results as j_extract
from pytracking_tpu.analysis import plot_results as j_plot
from pytracking_tpu.evaluation import running as j_running
from pytracking_tpu.evaluation.adapters import synthetic as j_syn
from pytracking_tpu.evaluation.data import Sequence as JSequence
from pytracking_tpu_torch.analysis import evaluate_vos as t_vos
from pytracking_tpu_torch.analysis import extract_results as t_extract
from pytracking_tpu_torch.analysis import plot_results as t_plot
from pytracking_tpu_torch.evaluation import running as t_running
from pytracking_tpu_torch.evaluation.adapters import synthetic as t_syn
from pytracking_tpu_torch.evaluation.data import Sequence as TSequence
from pytracking_tpu_torch.utils import png_io

TRACKERS = ("atom", "dimp", "dimp_simple", "eco", "keep_track", "kys", "lwl", "rts", "tamos",
            "tomp")


@pytest.fixture
def roots(tmp_path, monkeypatch):
    """Each package's root in its own directory; both settings caches reset."""
    monkeypatch.setenv("PYTRACKING_TPU_ROOT", str(tmp_path / "jax"))
    monkeypatch.setenv("PYTRACKING_TPU_TORCH_ROOT", str(tmp_path / "torch"))
    monkeypatch.setattr(j_env, "_env_settings", None)
    monkeypatch.setattr(t_env, "_env_settings", None)
    return tmp_path


# ---------------------------------------------------------------- datasets

@pytest.mark.parametrize("seed,frame,H,W", [(0, 0, 240, 320), (1, 7, 240, 320),
                                            (2, 19, 120, 160), (5, 119, 240, 320),
                                            (3, 4, 97, 131)])
def test_render_synthetic_frame_is_byte_identical(seed, frame, H, W):
    got = t_syn.render_synthetic_frame(seed, frame, H, W)
    ref = j_syn.render_synthetic_frame(seed, frame, H, W)
    assert got.dtype == ref.dtype == np.uint8 and got.tobytes() == ref.tobytes()
    assert t_syn.synthetic_gt_center(seed, frame, H, W) == j_syn.synthetic_gt_center(
        seed, frame, H, W)


@pytest.mark.parametrize("name", ["synthetic", "synthetic_long", "synthetic_vos"])
def test_synthetic_datasets_match_jax(name, roots):
    from pytracking_tpu.evaluation.datasets import get_dataset as j_get
    from pytracking_tpu_torch.evaluation.datasets import get_dataset as t_get

    got, ref = t_get(name), j_get(name)
    assert [s.name for s in got] == [s.name for s in ref]
    for g, r in zip(got, ref):
        assert g.frames == r.frames and g.dataset == r.dataset
        assert g.object_ids == r.object_ids and g.multiobj_mode == r.multiobj_mode
        assert g.ground_truth_rect.tobytes() == r.ground_truth_rect.tobytes()
        if r.ground_truth_seg is not None:
            assert all(a.tobytes() == b.tobytes()
                       for a, b in zip(g.ground_truth_seg, r.ground_truth_seg))
        gi, ri = g.init_info(), r.init_info()
        assert sorted(gi) == sorted(ri)
        for k in ri:
            np.testing.assert_array_equal(np.asarray(gi[k]), np.asarray(ri[k]))
    for uri in (got[0].frames[0], got[-1].frames[-1]):
        assert t_running._read_image(uri).tobytes() == j_running._read_image(uri).tobytes()


def test_registry_matches_jax_and_names_missing_adapters(roots, monkeypatch):
    """The registry's table is the JAX package's, and no adapter is
    missing: every name's module exists in the port with its class. The
    example experiments over NFS and UAV123 load from written trees."""
    import importlib
    import importlib.util

    from pytracking_tpu.evaluation.datasets import dataset_dict as j_dict
    from pytracking_tpu_torch.evaluation import benchmark_trees
    from pytracking_tpu_torch.evaluation import datasets as t_datasets

    t_dict = t_datasets.dataset_dict
    assert list(t_dict) == list(j_dict)
    for name, info in t_dict.items():
        ref = j_dict[name]
        assert info.module.startswith("pytracking_tpu_torch.evaluation.adapters.")
        assert info.module.rsplit(".", 1)[1] == ref.module.rsplit(".", 1)[1]
        assert (info.class_name, info.kwargs) == (ref.class_name, ref.kwargs)
        assert importlib.util.find_spec(info.module) is not None, name
        assert isinstance(getattr(importlib.import_module(info.module), info.class_name), type)
    missing = [n for n, i in t_dict.items() if importlib.util.find_spec(i.module) is None]
    assert missing == []
    with pytest.raises(ValueError, match="Unknown dataset"):
        t_datasets.get_dataset("no_such_dataset")
    paths = benchmark_trees.write_benchmark_trees(str(roots / "benchmarks"), size=(32, 24))
    for var, value in benchmark_trees.environment_variables(paths).items():
        monkeypatch.setenv(var, value)
    t_env.reset_env_settings()
    from pytracking_tpu_torch.experiments import myexperiments
    trackers, dataset = myexperiments.atom_nfs_uav(device="cpu")
    assert [t.run_id for t in trackers] == [0, 1, 2]
    assert [s.name for s in dataset] == [s.name for s in t_datasets.get_dataset("nfs")] + [
        s.name for s in t_datasets.get_dataset("uav")]
    assert [s.name for s in myexperiments.uav_test(device="cpu")[1]][:2] == ["uav_bike1",
                                                                           "uav_bird1_1"]
    t_env.reset_env_settings()


# ---------------------------------------------------------------- environment

def test_result_roots_are_apart(roots, monkeypatch):
    """The port's results never land in the JAX package's directories, and
    a JAX result file does not make the port skip; the dataset paths carry
    over from the JAX package's variables."""
    from pytracking_tpu.evaluation.tracker import Tracker as JTracker
    from pytracking_tpu_torch.evaluation.tracker import Tracker as TTracker

    for name in ("PYTRACKING_TPU_ROOT", "PYTRACKING_TPU_TORCH_ROOT"):
        monkeypatch.delenv(name)
    monkeypatch.setenv("HOME", str(roots / "home"))
    defaults = (j_env.EnvSettings(), t_env.EnvSettings())
    for path in t_env.OUTPUT_PATHS:
        assert getattr(defaults[0], path) != getattr(defaults[1], path)
    monkeypatch.setenv("PYTRACKING_TPU_RESULTS_PATH", str(roots / "jax_results"))
    monkeypatch.setenv("PYTRACKING_TPU_LASOT_PATH", str(roots / "lasot"))
    monkeypatch.setenv("PYTRACKING_TPU_TORCH_SEGMENTATION_PATH", str(roots / "segm"))
    env = t_env.EnvSettings()
    assert env.lasot_path == str(roots / "lasot")
    assert env.segmentation_path == str(roots / "segm")
    assert env.results_path == os.path.join(str(roots / "home"), "pytracking_tpu_torch_data",
                                            "tracking_results")

    monkeypatch.setenv("PYTRACKING_TPU_ROOT", str(roots / "jax"))
    monkeypatch.setenv("PYTRACKING_TPU_TORCH_ROOT", str(roots / "torch"))
    monkeypatch.delenv("PYTRACKING_TPU_RESULTS_PATH")
    monkeypatch.setattr(j_env, "_env_settings", None)
    t_env.reset_env_settings()
    seq = t_syn.SyntheticDataset(1, 3).get_sequence_list()[0]
    jt, tt = JTracker("dimp", "dimp50"), TTracker("dimp", "dimp50", device="cpu")
    os.makedirs(jt.results_dir)
    open(os.path.join(jt.results_dir, f"{seq.name}.txt"), "w").write("1\t2\t3\t4\n")
    assert j_running._results_exist(jt, seq)
    assert not t_running._results_exist(tt, seq)
    assert not tt.results_dir.startswith(str(roots / "jax"))


# ---------------------------------------------------------------- result files

class FixedTracker:
    """Returns given outputs: `init_out` from initialize, then one per frame."""

    def __init__(self, outputs, init_out=None):
        self.outputs, self.init_out, self.t = outputs, init_out or {}, 0

    def initialize(self, image, info):
        self.t = 0
        return dict(self.init_out)

    def track(self, image, info=None):
        self.t += 1
        return self.outputs[self.t - 1]


class Stub:
    """What run_sequence needs of `evaluation.tracker.Tracker`."""

    def __init__(self, root, make, name="fixed"):
        self.name, self.parameter_name, self.run_id = name, "default", None
        self.display_name = f"{name}_default"
        self.results_dir = os.path.join(root, "results", name)
        self.segmentation_dir = os.path.join(root, "segm", name)
        self._make = make

    def create_tracker(self, multiobj=False):
        return self._make()


def _box(rng):
    return (rng.rand(4) * [200, 150, 40, 30] + [0.3, 0.6, 5.2, 4.9]).tolist()


def _outputs(kind, n, shape, seed=0):
    """(per-frame outputs, init output) of a tracker of `kind`."""
    rng = np.random.RandomState(seed)
    if kind == "single":
        return [{"target_bbox": _box(rng), "object_presence_score": float(rng.rand())}
                for _ in range(n)], {}
    if kind == "multi":
        return [{"target_bbox": {o: _box(rng) for o in ("1", "2")},
                 "object_presence_score": {o: float(rng.rand()) for o in ("1", "2")}}
                for _ in range(n)], {}
    segs = [rng.randint(0, 3, shape).astype(np.uint8) for _ in range(n + 1)]
    outs = [{"target_bbox": {"1": _box(rng)}, "segmentation": s} for s in segs[1:]]
    return outs, ({"segmentation": segs[0]} if kind == "seg_init" else {})


def _oxuva_sequence(root, n):
    import cv2

    frames = []
    for t in range(n):
        p = os.path.join(root, f"{t * 30:06d}.png")
        cv2.imwrite(p, t_syn.render_synthetic_frame(0, t, 48, 64))
        frames.append(p)
    gt = np.tile([[5.0, 6.0, 20.0, 16.0]], (n, 1))
    return frames, gt


def _sequences(kind, root):
    """The same sequence as the JAX package's and the port's Sequence."""
    if kind == "oxuva":
        frames, gt = _oxuva_sequence(root, 5)
        kw = dict(name="vid7_obj2", frames=frames, dataset="oxuva", ground_truth_rect=gt)
    else:
        ds = j_syn.SyntheticVOSDataset(1, 6, 48, 64) if kind.startswith("seg") else \
            j_syn.SyntheticDataset(1, 6, 48, 64)
        s = ds.get_sequence_list()[0]
        kw = dict(name=s.name, frames=s.frames, dataset=s.dataset,
                  ground_truth_rect=s.ground_truth_rect, ground_truth_seg=s.ground_truth_seg,
                  init_data=s.init_data, object_ids=s.object_ids,
                  multiobj_mode=s.multiobj_mode)
        if kind == "multi":
            kw.update(object_ids=["1", "2"], multiobj_mode=True,
                      init_data={0: {"object_ids": ["1", "2"],
                                     "bbox": {"1": [4.0, 5.0, 10.0, 9.0],
                                              "2": [20.0, 21.0, 8.0, 7.0]}}})
    return JSequence(**kw), TSequence(**kw)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            out[os.path.relpath(os.path.join(d, n), root)] = open(os.path.join(d, n), "rb").read()
    return out


@pytest.mark.parametrize("kind", ["single", "multi", "seg_init", "seg_noinit", "oxuva"])
def test_result_files_are_byte_identical(kind, tmp_path):
    """The same tracker outputs through both harnesses write the same files:
    truncated int boxes, per-object files, presence scores, the OxUvA CSV,
    segmentation PNGs with the %05d names and the init-frame alignment."""
    jseq, tseq = _sequences(kind, str(tmp_path))
    outs, init = _outputs(kind if kind in ("single", "multi") else "seg_init"
                          if kind == "seg_init" else "seg", len(jseq.frames) - 1, (48, 64))
    if kind == "oxuva":
        outs, _ = _outputs("single", len(jseq.frames) - 1, None)
    jst = Stub(str(tmp_path / "jax"), lambda: FixedTracker(outs, init))
    tst = Stub(str(tmp_path / "torch"), lambda: FixedTracker(outs, init))
    jout = j_running.run_sequence(jseq, jst)
    tout = t_running.run_sequence(tseq, tst)
    assert jout is not None and tout is not None
    jf, tf = _files(str(tmp_path / "jax")), _files(str(tmp_path / "torch"))
    assert sorted(jf) == sorted(tf) and jf
    for name in jf:
        if name.endswith(".png"):        # the same array and palette (other zlib blocks)
            for a, b in zip(png_io.read_png(str(tmp_path / "torch" / name)),
                            png_io.read_png(str(tmp_path / "jax" / name))):
                np.testing.assert_array_equal(a, b)
        elif name.endswith("_time.txt"):
            assert len(tf[name].splitlines()) == len(jf[name].splitlines()) == len(jseq.frames)
            assert np.loadtxt(str(tmp_path / "torch" / name)).shape == (len(jseq.frames),)
        else:
            assert tf[name] == jf[name], name
    pngs = [n for n in tf if n.endswith(".png")]
    if kind.startswith("seg"):
        assert len(pngs) == len(jseq.frames) - (kind == "seg_noinit")
        assert ("segm/fixed/synthetic_vos_000/00000.png" in tf) == (kind == "seg_init")
    if kind == "oxuva":
        assert list(tf) == ["results/fixed/vid7_obj2.csv"]


def test_skip_if_done(roots, capsys):
    seq = t_syn.SyntheticDataset(1, 4, 48, 64).get_sequence_list()[0]
    outs, _ = _outputs("single", 3, None)
    st = Stub(str(roots / "torch"), lambda: FixedTracker(outs))
    assert t_running.run_sequence(seq, st) is not None
    assert "FPS" in capsys.readouterr().out
    assert t_running.run_sequence(seq, st) is None
    assert "skipping" in capsys.readouterr().out
    assert t_running.run_sequence(seq, st, debug=1) is not None    # debug runs again


def test_profile_dir_traces_the_first_sequence(roots):
    """profile_dir: a torch.profiler trace of the first sequence only."""
    ds = t_syn.SyntheticDataset(2, 3, 48, 64).get_sequence_list()
    outs, _ = _outputs("single", 2, None)
    st = Stub(str(roots / "torch"), lambda: FixedTracker(outs))
    t_running.run_dataset(ds, [st], profile_dir=str(roots / "trace"))
    traces = os.listdir(roots / "trace")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    assert sorted(os.listdir(st.results_dir)) == sorted(
        f"synthetic_00{i}{s}.txt" for i in (0, 1) for s in ("", "_time",
                                                            "_object_presence_scores"))


def test_annotation_helpers_match_jax(tmp_path):
    from pytracking_tpu.evaluation.adapters import _util as j_util
    from pytracking_tpu_torch.evaluation.adapters import _util as t_util

    for delim, name in ((",", "a.txt"), ("\t", "b.txt"), (" ", "c.txt")):
        np.savetxt(tmp_path / name, np.arange(12.0).reshape(3, 4) + 0.5, delimiter=delim)
        np.testing.assert_array_equal(t_util.load_text(str(tmp_path / name)),
                                      j_util.load_text(str(tmp_path / name)))
    np.testing.assert_array_equal(t_util.load_text(str(tmp_path / "b.txt"), ("\t", ",")),
                                  j_util.load_text(str(tmp_path / "b.txt"), ("\t", ",")))
    (tmp_path / "bad.txt").write_text("x y\n1")
    with pytest.raises(IOError):
        t_util.load_text(str(tmp_path / "bad.txt"))
    for n in ("0002.jpg", "0001.PNG", "notes.txt", "0003.jpeg"):
        (tmp_path / n).write_bytes(b"")
    assert t_util.list_frames(str(tmp_path)) == j_util.list_frames(str(tmp_path))
    assert [os.path.basename(p) for p in t_util.list_frames(str(tmp_path))] == [
        "0001.PNG", "0002.jpg", "0003.jpeg"]


def test_crashed_sequence_is_skipped_unless_debug(roots, capsys):
    class Crashing(FixedTracker):
        def track(self, image, info=None):
            raise RuntimeError("boom")

    seq = t_syn.SyntheticDataset(1, 3, 48, 64).get_sequence_list()[0]
    st = Stub(str(roots / "torch"), lambda: Crashing([]))
    assert t_running.run_sequence(seq, st) is None
    assert "crashed" in capsys.readouterr().out and not os.path.isdir(st.results_dir)
    with pytest.raises(RuntimeError, match="boom"):
        t_running.run_sequence(seq, st, debug=1)


# ---------------------------------------------------------------- analysis

def test_iou_and_robust_errors_match_jax():
    rng = np.random.RandomState(3)
    pred = rng.rand(40, 4) * [200, 150, 50, 40]
    anno = rng.rand(40, 4) * [200, 150, 50, 40] + [0, 0, 1, 1]
    pred[5, 2:] = 0.0                   # a lost frame carries the previous box
    anno[7] = [-1, -1, -1, -1]          # an invalid annotation
    vis = rng.rand(40) > 0.2
    np.testing.assert_allclose(t_extract.calc_iou_overlap(pred, anno),
                               j_extract.calc_iou_overlap(pred, anno), atol=1e-12, rtol=0)
    for dataset, visible, n in (("otb", None, 40), ("uav", None, 40), ("lasot", vis, 40),
                                ("otb", None, 35), ("otb", None, 45)):
        p = pred[:n] if n <= 40 else np.concatenate([pred, pred[:5]])
        got = t_extract.calc_seq_err_robust(p, anno, dataset, visible)
        ref = j_extract.calc_seq_err_robust(p, anno, dataset, visible)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, atol=1e-12, rtol=0)


def _oracle_results(roots, ds, noises, root_key):
    """Write oracle results (ground truth plus noise) of two trackers."""
    stubs = []
    for k, noise in enumerate(noises):
        st = Stub(str(roots / root_key), None, name=f"oracle{k}")
        for seq in ds:
            gt = np.asarray(seq.ground_truth_rect, float)
            rng = np.random.RandomState(k)
            outs = [{"target_bbox": (gt[t] + noise * rng.randn(4)).tolist(),
                     "object_presence_score": float(rng.rand())} for t in range(1, len(gt))]
            st._make = lambda outs=outs: FixedTracker(outs)
            t_running.run_sequence(seq, st)
        stubs.append(st)
    return stubs


def test_extract_results_pickles_match_jax(roots):
    """Either package's analysis on the port's result files: the pickled
    arrays, the score tables and the prec/rec/F1 pair agree."""
    ds = t_syn.SyntheticDataset(3, 12, 96, 128).get_sequence_list()
    trackers = _oracle_results(roots, ds, (1.5, 6.0), "torch")
    got = t_extract.extract_results(trackers, ds, report_name="rep")
    ref = j_extract.extract_results(trackers, ds, report_name="rep")
    t_pkl = pickle.load(open(roots / "torch" / "result_plots" / "rep" / "eval_data.pkl", "rb"))
    j_pkl = pickle.load(open(roots / "jax" / "result_plots" / "rep" / "eval_data.pkl", "rb"))
    for a, b in ((got, ref), (t_pkl, j_pkl)):
        assert sorted(a) == sorted(b)
        for k in b:
            if isinstance(b[k], list) and b[k] and not isinstance(b[k][0], (str, dict, bool)):
                np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), atol=1e-12,
                                           rtol=0, err_msg=k)
            else:
                assert a[k] == b[k], k
    ts, js = t_plot.get_scores(got), j_plot.get_scores(ref)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], atol=1e-12, rtol=0)
    assert ts["AUC"][0] > ts["AUC"][1] > 0
    pg = t_extract.extract_results_prec_rec_f1(trackers, ds, "prf")
    pr = j_extract.extract_results_prec_rec_f1(trackers, ds, "prf")
    for key, d in pr["raw_data"].items():
        for k in ("prec", "rec"):
            np.testing.assert_allclose(pg["raw_data"][key][k], d[k], atol=1e-12, rtol=0)
        for k in ("f1_max", "ths_max", "idx"):
            assert pg["raw_data"][key][k] == d[k]
    assert t_extract.print_results_prec_rec_f1(trackers, ds) == \
        j_extract.print_results_prec_rec_f1(trackers, ds)


def test_per_attribute_table_and_avist_spec(roots, capsys):
    """The AVisT-style scenario table over sequences' attributes, and the
    bundled AVisT scenario spec."""
    from pytracking_tpu.evaluation.adapters.avist import load_scenarios
    from pytracking_tpu_torch.evaluation import attribute_specs as t_specs

    ds = t_syn.SyntheticDataset(3, 10, 96, 128).get_sequence_list()
    for seq, att in zip(ds, (["R", "FO"], ["R"], ["LL"])):
        seq.attributes = att
    trackers = _oracle_results(roots, ds, (2.0,), "torch")
    specs = {"R": "Rain", "FO": "Fog", "LL": "Low-light"}
    got = t_plot.print_per_attribute_results(trackers, ds, "attr", attribute_specs=specs)
    out = capsys.readouterr().out
    ref = j_plot.print_per_attribute_results(trackers, ds, "attr", attribute_specs=specs)
    assert got == ref and set(got) == {"R", "FO", "LL"}
    assert "Rain" in out and "Low-light" in out
    assert all(row["oracle0_default"] > 70.0 for row in got.values())

    sc = t_specs.load_attribute_spec("avist_scenarios")
    assert sc == load_scenarios()
    assert len(sc["att_name_short"]) == len(sc["att_name_long"]) == 18
    entries = {k: v for k, v in sc.items() if not k.startswith("att_")}
    assert len(entries) > 100 and all(set(v) <= set(sc["att_name_short"])
                                      for v in entries.values())
    from pytracking_tpu.evaluation import attribute_specs as j_specs
    for dataset in ("otb", "lasot", "uav", "avist"):
        assert t_specs.load_attribute_spec(dataset) == j_specs.load_attribute_spec(dataset)
        names = sorted(k for k in t_specs.load_attribute_spec(dataset) if not k.startswith("att"))
        att = t_specs.attribute_names(dataset)[0]
        assert t_specs.attribute_names(dataset, "long") == j_specs.attribute_names(dataset, "long")
        assert t_specs.filter_names_by_attribute(dataset, names, att) == \
            j_specs.filter_names_by_attribute(dataset, names, att)
        assert t_specs.sequence_attributes(dataset, names[0]) == \
            j_specs.sequence_attributes(dataset, names[0])


def test_evaluate_vos_matches_jax(tmp_path, capsys):
    """J and F from the saved PNGs: per sequence, and over a dataset through
    either package's reader."""
    rng = np.random.RandomState(5)
    gt = [np.zeros((40, 56), np.uint8) for _ in range(9)]
    for t, m in enumerate(gt):
        m[5 + t:25 + t, 10:30] = 1
        m[20:34, 30 + t:48] = 2
    preds = [np.where(rng.rand(40, 56) < 0.1, rng.randint(0, 3, (40, 56)), m).astype(np.uint8)
             for m in gt]
    assert t_vos.evaluate_sequence(preds, gt, [1, 2]) == j_vos.evaluate_sequence(preds, gt,
                                                                                 [1, 2])
    for p, g in zip(preds, gt):
        assert t_vos.boundary_f_measure(p == 1, g == 1) == j_vos.boundary_f_measure(p == 1,
                                                                                    g == 1)
        assert t_vos.binary_jaccard(p == 2, g == 2) == j_vos.binary_jaccard(p == 2, g == 2)

    frames = [f"synthetic://0/{t}/40/56" for t in range(9)]
    kw = dict(name="vos_seq", frames=frames, dataset="synthetic_vos",
              ground_truth_rect=np.zeros((9, 4)), ground_truth_seg=gt, object_ids=["1", "2"])
    st = Stub(str(tmp_path), None, name="segm")
    os.makedirs(os.path.join(st.segmentation_dir, "vos_seq"))
    for t, p in enumerate(preds):
        png_io.imwrite_indexed(os.path.join(st.segmentation_dir, "vos_seq", f"{t:05d}.png"), p)
    got = t_vos.evaluate_vos([st], [TSequence(**kw)])
    ref = j_vos.evaluate_vos([st], [JSequence(**kw)])
    assert got == ref and 0.3 < got["segm_default"]["J-Mean"] < 1.0


# ---------------------------------------------------------------- multi-object

class SoftTracker:
    """One object: a box, a presence score and a soft mask that depend on
    the object and the frame."""

    def __init__(self, params, net=None, variables=None, device=None, **kw):
        self.params, self.kw = params, kw

    def initialize(self, image, info):
        self.oid, self.t = info["object_ids"][0], 0
        self.box = list(info["init_bbox"])
        return {}

    def track(self, image, info=None):
        self.t += 1
        rng = np.random.RandomState(int(self.oid) * 100 + self.t)
        return {"target_bbox": [b + self.t for b in self.box],
                "object_presence_score": float(rng.rand()),
                "segmentation_soft": rng.rand(*image.shape[:2]).astype(np.float32)}


def test_multi_object_wrapper_merges_match_jax():
    """Objects 1-2 from the first frame, object 3 from frame 3: boxes,
    presence scores and the soft-mask argmax merge equal."""
    from pytracking_tpu.evaluation.multi_object_wrapper import MultiObjectWrapper as JWrap
    from pytracking_tpu_torch.evaluation.multi_object_wrapper import MultiObjectWrapper as TWrap

    params = type("P", (), {"segmentation_threshold": 0.6})()
    jw = JWrap(SoftTracker, params, "net", "variables")
    tw = TWrap(SoftTracker, params, "net", device="cpu", tracker_kwargs={"extra": 1})
    im = np.zeros((30, 40, 3), np.uint8)
    init = {"init_bbox": OrderedDict([("1", [1.0, 2.0, 5.0, 6.0]), ("2", [9.0, 8.0, 4.0, 4.0])]),
            "object_ids": ["1", "2"], "init_object_ids": ["1", "2"]}
    assert tw.initialize(im, init) == jw.initialize(im, init)
    for t in range(1, 6):
        info = {"object_ids": ["1", "2"] + (["3"] if t >= 3 else [])}
        if t == 3:
            info.update(init_object_ids=["3"], init_bbox={"3": [20.0, 20.0, 3.0, 3.0]})
        got, ref = tw.track(im, info), jw.track(im, info)
        assert sorted(got) == sorted(ref)
        assert got["target_bbox"] == ref["target_bbox"]
        assert got["object_presence_score"] == ref["object_presence_score"]
        np.testing.assert_array_equal(got["segmentation"], ref["segmentation"])
    assert list(tw.trackers) == ["1", "2", "3"] and tw.trackers["3"].kw == {"extra": 1}
    assert tw.trackers["1"].params is params


# ---------------------------------------------------------------- routing

def _route(tracker_cls, create, multiobj, vmap, monkeypatch):
    """Which object the harness builds for a tracker class: 'wrapper',
    'vmap' or 'native'."""
    monkeypatch.setenv("PYTRACKING_TPU_VMAP_MULTIOBJ", "1" if vmap else "0")
    obj = create(multiobj)
    if type(obj).__name__ == "MultiObjectWrapper":
        return "wrapper"
    return "vmap" if type(obj).__name__ == "VmapStub" else "native"


@pytest.mark.parametrize("name", TRACKERS)
def test_multiobj_routing_matches_jax(name, monkeypatch):
    """For each tracker module, the port's class has the JAX class's
    `multiobj_mode` (and batched class), and the harness builds the same
    kind of tracker for single- and multi-object sequences, with and without
    PYTRACKING_TPU_VMAP_MULTIOBJ."""
    import importlib

    from pytracking_tpu.evaluation.tracker import Tracker as JTracker
    from pytracking_tpu.evaluation.tracker import TrackerSpec as JSpec
    from pytracking_tpu_torch.evaluation.tracker import Tracker as TTracker
    from pytracking_tpu_torch.trackers.base import TrackerSpec as TSpec

    jcls = importlib.import_module(f"pytracking_tpu.trackers.{name}").get_tracker_class()
    tcls = importlib.import_module(f"pytracking_tpu_torch.trackers.{name}").get_tracker_class()
    assert jcls.__name__ == tcls.__name__
    assert getattr(tcls, "multiobj_mode") == getattr(jcls, "multiobj_mode")
    jvm, tvm = (getattr(c, "vmap_multiobj_class", None) for c in (jcls, tcls))
    assert (tvm is None) == (jvm is None)
    if jvm is not None:
        assert tvm.__name__ == jvm.__name__ and tvm.multiobj_mode == jvm.multiobj_mode

    def stub_of(cls):
        class VmapStub:
            def __init__(self, *a, **k):
                pass

        attrs = {"multiobj_mode": cls.multiobj_mode, "__init__": lambda self, *a, **k: None}
        if getattr(cls, "vmap_multiobj_class", None) is not None:
            attrs["vmap_multiobj_class"] = VmapStub
        return type(cls.__name__, (), attrs)

    jt = JTracker.__new__(JTracker)
    jt.tracker_class, jt._spec = stub_of(jcls), JSpec(params=None)
    tt = TTracker.__new__(TTracker)
    tt.tracker_class, tt._spec, tt.device = stub_of(tcls), TSpec(params=None, net=None), "cpu"
    for multiobj in (False, True):
        for vmap in (False, True):
            assert _route(tcls, tt.create_tracker, multiobj, vmap, monkeypatch) == \
                _route(jcls, jt.create_tracker, multiobj, vmap, monkeypatch), (multiobj, vmap)


def test_precision_hooks_where_parameters_take_a_precision():
    """Every port parameter module whose `parameters()` takes a precision
    argument declares `precision_kwargs`, the others do not, and each
    translation names only arguments of its module's `parameters()`."""
    import importlib
    import inspect

    root = os.path.join(os.path.dirname(os.path.dirname(__file__)), "pytracking_tpu_torch",
                        "parameter")
    modules = sorted(f"{d}.{f[:-3]}" for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)) and d != "__pycache__"
                     for f in os.listdir(os.path.join(root, d))
                     if f.endswith(".py") and f != "__init__.py")
    hooked = []
    for name in modules:
        m = importlib.import_module(f"pytracking_tpu_torch.parameter.{name}")
        args = set(inspect.signature(m.parameters).parameters)
        takes = bool(args & {"dtype", "backbone_dtype", "weights_bf16"})
        assert hasattr(m, "precision_kwargs") == takes, name
        if takes:
            hooked.append(name)
            for bf16 in (False, True):
                for backbone in (False, True):
                    assert set(m.precision_kwargs(bf16, backbone)) <= args, (name, bf16, backbone)
    assert len(modules) >= 28 and len(hooked) == 11, hooked


# ---------------------------------------------------------------- png_io, pool

def test_png_io_against_pil(tmp_path):
    """PIL reads the port's files to the same array and palette, the port
    reads PIL's (also its 1/2/4-bit palettes and grey, RGB and RGBA files)."""
    from PIL import Image

    import pytracking_tpu.utils.png_io as j_png

    rng = np.random.RandomState(0)
    for shape in ((37, 53), (240, 320)):
        a = rng.randint(0, 6, shape).astype(np.uint8)
        png_io.imwrite_indexed(str(tmp_path / "t.png"), a)
        j_png.imwrite_indexed(str(tmp_path / "j.png"), a)
        im = Image.open(tmp_path / "t.png")
        assert im.mode == "P" and np.array_equal(np.asarray(im), a)
        pal = np.asarray(im.getpalette(), np.uint8).reshape(-1, 3)
        np.testing.assert_array_equal(pal, png_io._PALETTE)
        np.testing.assert_array_equal(png_io.imread_indexed(str(tmp_path / "j.png")), a)
        np.testing.assert_array_equal(j_png.imread_indexed(str(tmp_path / "t.png")), a)
    big = rng.randint(0, 255, (300, 400)).astype(np.uint8)      # over 64 KiB compressed
    png_io.imwrite_indexed(str(tmp_path / "big.png"), big)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "big.png")), big)
    small = rng.randint(0, 3, (19, 23)).astype(np.uint8)
    for colors in (2, 4, 16):                  # PIL writes 1, 2 and 4 bits per pixel
        labels = small % colors
        im = Image.fromarray(labels, "P")
        im.putpalette(list(range(3 * colors)))
        im.save(tmp_path / "low.png")
        np.testing.assert_array_equal(png_io.imread_indexed(str(tmp_path / "low.png")), labels)
    for mode, arr in (("L", rng.randint(0, 255, (21, 30)).astype(np.uint8)),
                      ("RGB", rng.randint(0, 255, (21, 30, 3)).astype(np.uint8)),
                      ("RGBA", rng.randint(0, 255, (21, 30, 4)).astype(np.uint8))):
        Image.fromarray(arr, mode).save(tmp_path / "x.png", optimize=True)
        got, _ = png_io.read_png(str(tmp_path / "x.png"))
        np.testing.assert_array_equal(got.reshape(arr.shape), arr)


def test_pool_jobs_carry_device_and_precision(roots, monkeypatch):
    """threads > 0: each job rebuilds its tracker from its name, parameter
    name, run id, display name, device and precision (the variables'
    values when the jobs are made)."""
    import multiprocessing

    from pytracking_tpu_torch.evaluation.tracker import Tracker

    seen = []

    class Pool:
        def __init__(self, n):
            assert n == 2

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def map(self, fn, jobs):
            seen.extend(jobs)
            return ["report"] * len(jobs)

    class Ctx:
        def Pool(self, n):
            return Pool(n)

    monkeypatch.setattr(multiprocessing, "get_context",
                        lambda kind: Ctx() if kind == "spawn" else None)
    monkeypatch.setenv("PYTRACKING_TPU_BF16", "1")
    ds = t_syn.SyntheticDataset(2, 3, 48, 64).get_sequence_list()
    trackers = [Tracker("dimp", "dimp50", run_id=4, device="cpu"),
                Tracker("tamos", "tamos_resnet50", display_name="T", device="cpu",
                        bf16=False, bf16_backbone=True)]
    assert t_running.run_dataset(ds, trackers, threads=2) == ["report"] * 4
    assert [(s.name, info) for s, info, _ in seen[:2]] == [
        ("synthetic_000", dict(name="dimp", parameter_name="dimp50", run_id=4,
                               display_name=None, device="cpu", bf16=True,
                               bf16_backbone=False)),
        ("synthetic_000", dict(name="tamos", parameter_name="tamos_resnet50", run_id=None,
                               display_name="T", device="cpu", bf16=False,
                               bf16_backbone=True))]
    rebuilt = Tracker(**seen[1][1])
    assert rebuilt.precision() == (False, True) and rebuilt.precision_kwargs() == {}
    assert Tracker(**seen[0][1]).precision_kwargs() == {"dtype": __import__("torch").bfloat16}
