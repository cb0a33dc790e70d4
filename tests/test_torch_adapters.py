"""The port's dataset adapters against the JAX package's, on the CPU, on
one written tree per benchmark (`evaluation/benchmark_trees.py`: 32x24
JPEG frames, 4 per sequence, with each benchmark's irregular cases).

Every registry name, and every keyword variant the adapters take, gives the
same SequenceList in both packages, field for field: names and order,
frame paths, ground-truth boxes (values and dtype), visibility, object ids,
the multi-object flag, the initialisation data and masks, segmentation
paths and attributes. Frames decode bit for bit alike through both
packages' `_read_image` (JPEG and PNG). No network is built.
"""

import os

import numpy as np
import pytest

import pytracking_tpu.evaluation.environment as j_env
import pytracking_tpu_torch.evaluation.environment as t_env
from pytracking_tpu.evaluation import datasets as j_datasets
from pytracking_tpu.evaluation import running as j_running
from pytracking_tpu_torch.evaluation import benchmark_trees
from pytracking_tpu_torch.evaluation import datasets as t_datasets
from pytracking_tpu_torch.evaluation import running as t_running

SIZE = (32, 24)
REGISTRY = [n for n in t_datasets.dataset_dict if not n.startswith("synthetic")]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("benchmarks")
    return str(root), benchmark_trees.write_benchmark_trees(str(root), size=SIZE)


@pytest.fixture
def env(trees, monkeypatch, tmp_path):
    """Both packages pointed at the trees; results under tmp_path."""
    root, paths = trees
    for name, value in benchmark_trees.environment_variables(paths).items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("PYTRACKING_TPU_ROOT", str(tmp_path / "jax"))
    monkeypatch.setenv("PYTRACKING_TPU_TORCH_ROOT", str(tmp_path / "torch"))
    monkeypatch.setattr(j_env, "_env_settings", None)
    t_env.reset_env_settings()
    yield root, paths
    t_env.reset_env_settings()


def _same(got, ref, where):
    """Equal values of equal types: arrays by dtype, shape and contents,
    dicts by their keys in order, lists item by item."""
    if isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == ref.dtype and got.shape == ref.shape, \
            f"{where}: {got.dtype}{got.shape} vs {ref.dtype}{ref.shape}"
        np.testing.assert_array_equal(got, ref, err_msg=where)
    elif isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), f"{where}: {list(got)}"
        for k in ref:
            _same(got[k], ref[k], f"{where}[{k!r}]")
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref), f"{where}: {got!r}"
        for i, (g, r) in enumerate(zip(got, ref)):
            _same(g, r, f"{where}[{i}]")
    else:
        assert type(got) is type(ref) and got == ref, f"{where}: {got!r} vs {ref!r}"


def assert_same_sequences(got, ref, root):
    """Two SequenceLists field for field; every frame path lies in the tree."""
    assert [s.name for s in got] == [s.name for s in ref]
    assert len(ref) > 0
    for g, r in zip(got, ref):
        w = r.name
        assert type(g).__name__ == type(r).__name__ == "Sequence"
        _same(g.frames, r.frames, f"{w}.frames")
        assert all(os.path.relpath(p, root) == os.path.relpath(q, root)
                   and not os.path.relpath(p, root).startswith("..")
                   for p, q in zip(g.frames, r.frames)), w
        for field in ("dataset", "ground_truth_rect", "ground_truth_seg", "target_visible",
                      "object_ids", "multiobj_mode", "object_class", "attributes", "init_data"):
            _same(getattr(g, field), getattr(r, field), f"{w}.{field}")
        for k in r.init_data:
            _same(g.object_init_data(k), r.object_init_data(k), f"{w}.object_init_data({k})")
        _same(g.init_info(), r.init_info(), f"{w}.init_info()")


@pytest.mark.parametrize("name", REGISTRY)
def test_registry_name_matches_jax(name, env):
    root, _ = env
    got, ref = t_datasets.get_dataset(name), j_datasets.get_dataset(name)
    assert_same_sequences(got, ref, root)
    assert all(os.path.isfile(p) for s in got for p in s.frames), name


CLASS_VARIANTS = [
    ("otb", "OTBDataset", {"attribute": "FM"}),
    ("otb", "OTBDataset", {"attribute": "Occlusion"}),
    ("lasot", "LaSOTDataset", {"attribute": "DEF"}),
    ("lasot", "LaSOTDataset", {"attribute": "Viewpoint Change", "vos_mode": True}),
    ("lasot", "LaSOTTrainSequencesDataset", {"vos_mode": True}),
    ("got10k", "GOT10KDataset", {"split": "ltrval", "vos_mode": True}),
    ("got10k", "GOT10KDataset", {"split": "test", "vos_mode": True}),
    ("trackingnet", "TrackingNetDataset", {"load_frames": False}),
    ("trackingnet", "TrackingNetDataset", {"load_frames": False, "vos_mode": True}),
    ("vot", "VOTDataset", {"year": 22}),
    ("tpl", "TPLDataset", {"exclude_otb": False}),
    ("davis", "DavisDataset", {"version": "2017", "split": "test-dev"}),
    ("youtubevos", "YouTubeVOSDataset", {"version": "2019", "split": "train"}),
    ("youtubevos", "YouTubeVOSDataset", {"version": "2019", "split": "train",
                                         "cleanup": ["starts"]}),
    ("youtubevos", "YouTubeVOSDataset", {"version": "2018", "split": "jjvalid",
                                         "all_frames": True}),
    ("oxuva", "OxUvADataset", {"split": "test"}),
    ("lagot", "LaGOTDataset", {"sot_mode": False}),
    ("mobiface", "MobifaceDataset", {"split": "all"}),
]


@pytest.mark.parametrize("module,cls,kwargs", CLASS_VARIANTS,
                         ids=[f"{m}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for m, _, kw in CLASS_VARIANTS])
def test_adapter_variant_matches_jax(module, cls, kwargs, env):
    import importlib

    root, _ = env
    got = getattr(importlib.import_module(
        f"pytracking_tpu_torch.evaluation.adapters.{module}"), cls)(**kwargs)
    ref = getattr(importlib.import_module(
        f"pytracking_tpu.evaluation.adapters.{module}"), cls)(**kwargs)
    assert_same_sequences(got.get_sequence_list(), ref.get_sequence_list(), root)


def test_youtubevos_aspect_cleanup_matches_jax(env, monkeypatch, tmp_path):
    """cleanup=['aspect'] drops the 4:3 trees' sequences and keeps those of
    a 16:9 tree (48x27 frames)."""
    from pytracking_tpu.evaluation.adapters.youtubevos import YouTubeVOSDataset as JYT
    from pytracking_tpu_torch.evaluation.adapters.youtubevos import YouTubeVOSDataset as TYT

    root, _ = env
    kw = {"version": "2019", "split": "valid", "cleanup": ["aspect", "starts"]}
    assert TYT(**kw).get_sequence_list() == [] == JYT(**kw).get_sequence_list()
    wide = benchmark_trees.write_benchmark_trees(str(tmp_path / "wide"), size=(48, 27))
    monkeypatch.setenv("PYTRACKING_TPU_YOUTUBEVOS_DIR", wide["youtubevos_dir"])
    monkeypatch.setattr(j_env, "_env_settings", None)
    t_env.reset_env_settings()
    got, ref = TYT(**kw).get_sequence_list(), JYT(**kw).get_sequence_list()
    assert len(got) == 2
    assert_same_sequences(got, ref, str(tmp_path / "wide"))


def test_attribute_filter_and_tables_match_jax(env):
    """`get_dataset(..., attribute=)` and `get_dataset_attributes` for the
    benchmarks with attribute annotations (OTB, LaSOT) and one without
    (NFS); a LaSOT training split without its split file is every
    sequence on disk, in both packages."""
    root, _ = env
    for name, att in (("otb", "IV"), ("otb", "Fast Motion"), ("lasot", "FOC"), ("uav", None)):
        kw = {} if att is None else {"attribute": att}
        got, ref = t_datasets.get_dataset(name, **kw), j_datasets.get_dataset(name, **kw)
        if att is not None:
            assert len(got) < len(t_datasets.get_dataset(name))
        assert [s.name for s in got] == [s.name for s in ref] and len(ref)
        assert_same_sequences(got, ref, root)
    for name in ("otb", "lasot", "nfs"):
        got = t_datasets.get_dataset_attributes(name)
        ref = j_datasets.get_dataset_attributes(name)
        assert list(got) == list(ref)
        for att in ref:
            assert [s.name for s in got[att]] == [s.name for s in ref[att]], (name, att)
    with pytest.raises(ValueError, match="attribute invalid"):
        t_datasets.get_dataset("otb", attribute="no_such_attribute")
    os.environ.pop("PYTRACKING_TPU_DATA_SPECS_PATH")
    assert_same_sequences(t_datasets.get_dataset("lasot_train"),
                          j_datasets.get_dataset("lasot_train"), root)
    assert len(t_datasets.get_dataset("lasot_train")) == len(t_datasets.get_dataset("lasot"))
    with pytest.raises(FileNotFoundError, match="youtubevos_jjvalid"):
        t_datasets.get_dataset("yt2019_jjval")


SETTING_OF = {"otb": "otb_path", "nfs": "nfs_path", "uav": "uav_path", "lasot": "lasot_path",
              "lasot_train": "lasot_path", "lasot_extension_subset":
              "lasot_extension_subset_path", "got10k_val": "got10k_path",
              "trackingnet": "trackingnet_path", "vot": "vot_path", "avist": "avist_path",
              "tpl": "tpl_path", "dv2017_val": "davis_dir", "yt2019_valid": "youtubevos_dir",
              "oxuva_dev": "oxuva_path", "lagot": "lagot_path", "lagot_sot": "lasot_path",
              "mobiface_all": "mobiface_path"}


@pytest.mark.parametrize("name", list(SETTING_OF))
def test_missing_tree_raises(name, env, monkeypatch, tmp_path):
    """An empty or wrong dataset path raises, naming its setting; no
    adapter reads a missing tree as an empty dataset."""
    var = "PYTRACKING_TPU_" + SETTING_OF[name].upper()
    for value in ("", str(tmp_path / "absent")):
        monkeypatch.setenv(var, value)
        t_env.reset_env_settings()
        with pytest.raises(FileNotFoundError, match=SETTING_OF[name]):
            t_datasets.get_dataset(name)


def test_unknown_splits_raise(env):
    from pytracking_tpu_torch.evaluation.adapters.mobiface import MobifaceDataset
    from pytracking_tpu_torch.evaluation.adapters.oxuva import OxUvADataset

    with pytest.raises(ValueError, match="MobiFace split"):
        MobifaceDataset(split="val")
    with pytest.raises(ValueError, match="not a valid option"):
        OxUvADataset(split="val")


@pytest.mark.parametrize("kind", ["jpeg_cv2", "jpeg_pil_q75", "jpeg_pil_q95", "png", "tree"])
def test_read_image_matches_jax(kind, env, tmp_path):
    """Both packages' `_read_image` decode the same RGB bytes (the port
    with OpenCV, the JAX package with its JPEG decoder or PIL)."""
    import cv2
    from PIL import Image

    rng = np.random.RandomState(3)
    paths = []
    for k, (h, w) in enumerate([(24, 32), (97, 131), (480, 854)]):
        im = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        im[h // 4: h // 2, w // 4: w // 2] = [200, 40, 90]
        p = str(tmp_path / f"{k}.{'png' if kind == 'png' else 'jpg'}")
        if kind in ("jpeg_cv2", "tree"):
            cv2.imwrite(p, im[:, :, ::-1])
        else:
            Image.fromarray(im).save(p, **({} if kind == "png" else {"quality": int(kind[-2:])}))
        paths.append(p)
    if kind == "tree":                        # frames the trees' writer made with OpenCV
        paths = [t_datasets.get_dataset("otb")[0].frames[0],
                 t_datasets.get_dataset("dv2017_val")[0].frames[1],
                 t_datasets.get_dataset("oxuva_dev")[0].frames[0]]
    for p in paths:
        got, ref = t_running._read_image(p), j_running._read_image(p)
        assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape, p
        assert got.tobytes() == ref.tobytes(), p
        if kind == "png":
            assert got.tobytes() == np.asarray(Image.open(p).convert("RGB")).tobytes()


def test_written_trees_hold_the_benchmark_layouts(env):
    """The trees' own contract: frame sizes, VOS labels and the boxes of
    the rendered square."""
    from pytracking_tpu_torch.utils.png_io import imread_indexed

    seq = t_datasets.get_dataset("dv2017_val")["bike-packing"]
    assert seq.object_ids == ["1", "2"] and len(seq.frames) == 4
    assert sorted(np.unique(imread_indexed(seq.ground_truth_seg[1]))) == [0, 1, 2]
    im = t_running._read_image(t_datasets.get_dataset("otb")[0].frames[0])
    assert im.shape == (SIZE[1], SIZE[0], 3)
    yt = t_datasets.get_dataset("yt2019_valid")["0a49f5265b"]
    assert sorted(yt.init_data) == [0, 1] and yt.init_data[1]["object_ids"] == ["2"]
    jj = t_datasets.get_dataset("yt2019_jjval")
    assert list(jj[0].init_data) == [2]          # 00065, after the two unlabelled frames
    assert list(t_datasets.get_dataset("yt2018_jjval")[0].init_data) == [0]


class _MaskStub:
    """A tracker that keeps its first box and mask (for the harness only)."""
    multiobj_mode = "parallel"

    def __init__(self, params=None, net=None, device="cpu"):
        self.inits = []

    def initialize(self, image, info):
        self.inits.append(info)
        self.box, self.mask = list(info["init_bbox"]), np.asarray(info["init_mask"])
        return {"segmentation": self.mask}

    def track(self, image, info=None):
        return {"target_bbox": self.box, "segmentation": self.mask}


class _NativeMaskStub(_MaskStub):
    """A natively multi-object tracker that starts from the label map alone
    and returns no box on its first frame (as LWLMultiObjectTracker)."""
    multiobj_mode = "default"

    def initialize(self, image, info):
        self.inits.append(info)
        from pytracking_tpu_torch.evaluation.multi_object_wrapper import mask_extent_box

        self.mask = np.asarray(info["init_mask"])
        self.boxes = {o: mask_extent_box(self.mask == int(o)) for o in info["object_ids"]}
        return {"segmentation": self.mask}

    def track(self, image, info=None):
        return {"target_bbox": self.boxes, "segmentation": self.mask}


@pytest.mark.parametrize("route", ["wrapper", "native"])
def test_mask_only_objects_start_from_their_masks(route, env, tmp_path):
    """DAVIS gives its objects by their first mask alone: through the
    MultiObjectWrapper each object's tracker gets its mask's extent as its
    box, and the result file's first row is that box on both routes (the
    JAX harness has no box for that row and raises)."""
    from types import SimpleNamespace

    from pytracking_tpu_torch.evaluation.multi_object_wrapper import (MultiObjectWrapper,
                                                                       mask_extent_box)
    from pytracking_tpu_torch.utils.png_io import imread_indexed

    seq = t_datasets.get_dataset("dv2017_val")["bike-packing"]
    built = []

    def create_tracker(multiobj=False):
        assert multiobj
        built.append(MultiObjectWrapper(_MaskStub, None, device="cpu") if route == "wrapper"
                     else _NativeMaskStub())
        return built[-1]

    tracker = SimpleNamespace(name="stub", parameter_name=route, create_tracker=create_tracker,
                              results_dir=str(tmp_path / "results"),
                              segmentation_dir=str(tmp_path / "segmentation"))
    t_running.run_sequence(seq, tracker, debug=1)
    first = imread_indexed(seq.ground_truth_seg[0])
    for oid in ("1", "2"):
        box = mask_extent_box(first == int(oid))
        assert box[2] > 1 and box[3] > 1
        rows = np.loadtxt(str(tmp_path / "results" / f"bike-packing_{oid}.txt"), ndmin=2)
        assert rows.shape == (len(seq.frames), 4)
        np.testing.assert_array_equal(rows, np.tile(np.asarray(box).astype(int), (len(rows), 1)))
        if route == "wrapper":
            assert built[0].trackers[oid].inits[0]["init_bbox"] == box
    assert len(os.listdir(tmp_path / "segmentation" / "bike-packing")) == len(seq.frames)
