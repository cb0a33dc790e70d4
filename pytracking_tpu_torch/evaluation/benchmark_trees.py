"""Small trees in the on-disk layouts of the 15 benchmarks the adapters read
(OTB, NFS, UAV123, LaSOT, LaSOT-ext, GOT-10k, TrackingNet, VOT, AVisT,
TC128, DAVIS, YouTube-VOS, OxUvA, LaGOT, MobiFace), for a dry run of the
harness, `run_vot` and the packers where the benchmarks are not on disk.

    paths = write_benchmark_trees("/tmp/benchmarks")
    os.environ.update(environment_variables(paths))
    get_dataset("otb")

Frames are the synthetic renderer's (`adapters/synthetic.py`: a moving
square over a textured background, two static distractors) written as JPEG
by OpenCV, at each benchmark's frame size unless `size` is given; the boxes
are the square's, the VOS masks indexed PNGs of the square (object 1) and of
a distractor (object 2). Each tree also holds the irregular cases its
adapter handles: OTB's two-target and offset sequences, UAV123's shared
folders, LaSOT's two folder layouts, VOT polygons, YouTube-VOS objects that
start mid-sequence and the known bad start frames, frames without an
annotation, and folders that are not sequences.
"""

from __future__ import annotations

import json
import os

import numpy as np

from pytracking_tpu_torch.evaluation.adapters.synthetic import (render_synthetic_frame,
                                                                synthetic_gt_center)
from pytracking_tpu_torch.utils.png_io import imwrite_indexed

# (width, height) of each benchmark's frames
FRAME_SIZES = {"otb": (640, 480), "nfs": (640, 480), "uav": (640, 480), "tpl": (640, 480),
               "lasot": (1280, 720), "lasot_extension_subset": (1280, 720),
               "got10k": (1280, 720), "trackingnet": (1280, 720), "vot": (1280, 720),
               "avist": (1280, 720), "oxuva": (1280, 720), "mobiface": (1280, 720),
               "youtubevos": (1280, 720), "davis": (854, 480)}

# the environment settings the trees fill (PYTRACKING_TPU_<NAME>)
SETTINGS = ("otb_path", "nfs_path", "uav_path", "tpl_path", "vot_path", "got10k_path",
            "got10k_mask_path", "lasot_path", "lasot_mask_path", "lasot_extension_subset_path",
            "trackingnet_path", "trackingnet_mask_path", "davis_dir", "youtubevos_dir",
            "avist_path", "oxuva_path", "lagot_path", "mobiface_path")


def environment_variables(paths: dict) -> dict:
    """The variables that point both packages at the trees."""
    env = {"PYTRACKING_TPU_" + name.upper(): path for name, path in paths.items()
           if name in SETTINGS}
    env["PYTRACKING_TPU_DATA_SPECS_PATH"] = paths["data_specs_path"]
    return env


class _Writer:
    def __init__(self, root, frames, size, tracked):
        self.root = os.path.abspath(root)
        self.frames = frames
        self.size = size
        self.tracked = tracked or {}
        self.seed = 0

    def path(self, *parts):
        p = os.path.join(self.root, *parts)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    def wh(self, bench):
        return self.size or FRAME_SIZES[bench]

    def count(self, bench, first):
        """Frames of a sequence: more for the first one of a tracked
        benchmark."""
        return self.tracked.get(bench, self.frames) if first else self.frames

    def sequence(self, bench, paths):
        """Render one sequence into `paths` (one per frame); returns its
        seed and (N, 4) boxes."""
        import cv2

        seed, self.seed = self.seed, self.seed + 1
        W, H = self.wh(bench)
        boxes = []
        for t, p in enumerate(paths):
            im = render_synthetic_frame(seed, t, H, W)
            # the renderer's texture covers whole 8x8 blocks: repeat its edge
            im = np.pad(im, ((0, H - im.shape[0]), (0, W - im.shape[1]), (0, 0)), mode="edge")
            if not cv2.imwrite(self.path(p), np.ascontiguousarray(im[:, :, ::-1])):
                raise OSError(f"cv2.imwrite failed for {p}")
            cy, cx, sz = synthetic_gt_center(seed, t, H, W)
            boxes.append([cx - sz / 2, cy - sz / 2, sz, sz])
        return seed, np.round(np.asarray(boxes, np.float64), 2)

    def text(self, rel, rows, delimiter=",", fmt="%.2f", header=None):
        kw = {"header": header, "comments": ""} if header else {}
        np.savetxt(self.path(rel), np.atleast_2d(rows), delimiter=delimiter, fmt=fmt, **kw)

    def lines(self, rel, lines):
        with open(self.path(rel), "w") as f:
            f.write("".join(line + "\n" for line in lines))


def vos_mask(seed: int, t: int, W: int, H: int, objects: int = 2) -> np.ndarray:
    """(H, W) labels of frame t of a rendered sequence: the square is
    object 1 and, with objects = 2, the first distractor object 2 (the
    square drawn over it, as in the frame)."""
    m = np.zeros((H, W), np.uint8)

    def fill(cy, cx, sz, label):
        y0, y1 = int(max(cy - sz / 2, 0)), int(min(cy + sz / 2, H))
        x0, x1 = int(max(cx - sz / 2, 0)), int(min(cx + sz / 2, W))
        m[y0:y1, x0:x1] = label

    cy, cx, sz = synthetic_gt_center(seed, t, H, W)
    if objects > 1:
        rng = np.random.RandomState(seed)    # the renderer's draws up to the distractor
        rng.rand(H // 8, W // 8, 3)
        rng.rand(3)
        dy, dx = rng.rand(2) * [H, W]
        fill(dy, dx, sz * 0.8, 2)
    fill(cy, cx, sz, 1)
    return m


def write_benchmark_trees(root: str, frames: int = 4, size=None, tracked=None) -> dict:
    """Write the 15 trees under `root`; returns {setting name: path} with
    'data_specs_path' (the split files of `lasot_train` and the YouTube-VOS
    jj splits). frames: frames per sequence (at least 4); size: (W, H) of
    every frame, None for each benchmark's own; tracked: {benchmark:
    frames} of the first sequence of the benchmarks named (the sequence a
    run tracks: 'otb' Basketball, 'lasot' lion-3, 'davis' bike-packing,
    'vot' ants1)."""
    if frames < 4:
        raise ValueError("the trees need 4 frames per sequence or more")
    w = _Writer(root, frames, size, tracked)
    paths = {}
    for fn in (_otb, _nfs, _uav, _lasot, _got10k, _trackingnet, _vot, _avist, _tpl, _davis,
               _youtubevos, _oxuva, _mobiface):
        paths.update(fn(w))
    paths.update(_lagot(w, paths["lasot_path"]))
    w.lines("data_specs/lasot_train_split.txt", ["person-20", "truck-1"])
    w.lines("data_specs/youtubevos_jjvalid.txt", ["0e27472bea"])
    paths["data_specs_path"] = os.path.join(w.root, "data_specs")
    return paths


def _otb(w):
    n = w.frames
    _, gt = w.sequence("otb", [f"OTB100/Basketball/img/{i:04d}.jpg"
                               for i in range(1, w.count("otb", True) + 1)])
    w.text("OTB100/Basketball/groundtruth_rect.txt", gt)
    _, gt = w.sequence("otb", [f"OTB100/Jogging/img/{i:04d}.jpg" for i in range(1, n + 1)])
    w.text("OTB100/Jogging/groundtruth_rect.1.txt", gt, delimiter="\t")
    w.text("OTB100/Jogging/groundtruth_rect.2.txt", gt + [3.0, 2.0, 0.0, 0.0])
    _, gt = w.sequence("otb", [f"OTB100/Human4/img/{i:04d}.jpg" for i in range(1, n + 1)])
    w.text("OTB100/Human4/groundtruth_rect.2.txt", gt)
    # Tiger1 starts at frame 6 of its folder
    _, gt = w.sequence("otb", [f"OTB100/Tiger1/img/{i:04d}.jpg" for i in range(1, n + 6)])
    w.text("OTB100/Tiger1/groundtruth_rect.txt", gt[5:])
    # David's frames 300-770, of which this tree holds none: the folder's first frames
    _, gt = w.sequence("otb", [f"OTB100/David/img/{i:04d}.jpg" for i in range(1, n + 1)])
    w.text("OTB100/David/groundtruth_rect.txt", gt[:n - 1])
    w.lines("OTB100/readme/notes.txt", ["not a sequence"])
    return {"otb_path": os.path.join(w.root, "OTB100")}


def _nfs(w):
    for name in ("Gymnastics", "airboard_1"):
        n = w.frames
        _, gt = w.sequence("nfs", [f"NFS/{name}/30/{name}/{i:05d}.jpg" for i in range(1, n + 1)])
        rows = np.c_[np.ones(n), gt[:, :2], gt[:, :2] + gt[:, 2:], np.arange(n), np.zeros((n, 3))]
        w.text(f"NFS/{name}/30/{name}.txt", rows, delimiter=" ", fmt="%g")
    w.lines("NFS/no_30fps/240/readme.txt", ["240 fps only"])
    return {"nfs_path": os.path.join(w.root, "NFS")}


def _uav(w):
    for name in ("bike1", "car1_s"):
        _, gt = w.sequence("uav", [f"UAV123/data_seq/UAV123/{name}/{i:06d}.jpg"
                                   for i in range(1, w.frames + 1)])
        w.text(f"UAV123/anno/UAV123/{name}.txt", gt)
    # bird1_1 and bird1_2 read the folder bird1
    _, gt = w.sequence("uav", [f"UAV123/data_seq/UAV123/bird1/{i:06d}.jpg"
                               for i in range(1, w.frames + 1)])
    w.text("UAV123/anno/UAV123/bird1_1.txt", gt[:w.frames - 1])
    w.text("UAV123/anno/UAV123/bird1_2.txt", gt)
    w.text("UAV123/anno/UAV123/no_folder.txt", gt)
    return {"uav_path": os.path.join(w.root, "UAV123")}


def _lasot_sequence(w, root, rel, bench, first, visibility):
    name = os.path.basename(rel)
    n = w.count(bench, first)
    seed, gt = w.sequence(bench, [f"{root}/{rel}/img/{i:08d}.jpg" for i in range(1, n + 1)])
    w.text(f"{root}/{rel}/groundtruth.txt", gt, fmt="%d")
    if visibility:
        occ = np.zeros((1, n), int)
        occ[0, 1] = 1
        oov = np.zeros((1, n), int)
        oov[0, -1] = 1
        w.text(f"{root}/{rel}/full_occlusion.txt", occ, fmt="%d")
        w.text(f"{root}/{rel}/out_of_view.txt", oov, fmt="%d")
    return name, seed, n


def _lasot(w):
    # the class-folder layout for lion-3 and person-20, a flat one for truck-1
    name, seed, _ = _lasot_sequence(w, "LaSOT", "lion/lion-3", "lasot", True, True)
    W, H = w.wh("lasot")
    imwrite_indexed(w.path("LaSOT_masks", name, "00000001.png"), vos_mask(seed, 0, W, H, 1))
    _lasot_sequence(w, "LaSOT", "person/person-20", "lasot", False, True)
    _lasot_sequence(w, "LaSOT", "truck-1", "lasot", False, False)
    _lasot_sequence(w, "LaSOT_extension", "atv/atv-1", "lasot_extension_subset", False, True)
    _lasot_sequence(w, "LaSOT_extension", "wingsuit/wingsuit-3", "lasot_extension_subset",
                    False, False)
    return {"lasot_path": os.path.join(w.root, "LaSOT"),
            "lasot_mask_path": os.path.join(w.root, "LaSOT_masks"),
            "lasot_extension_subset_path": os.path.join(w.root, "LaSOT_extension")}


def _got10k(w):
    names = ["GOT-10k_Test_000002", "GOT-10k_Test_000001"]
    for name in names:            # the test split holds each sequence's first box
        _, gt = w.sequence("got10k", [f"GOT10k/test/{name}/{i:08d}.jpg"
                                      for i in range(1, w.frames + 1)])
        w.text(f"GOT10k/test/{name}/groundtruth.txt", gt[:1], fmt="%.4f")
    w.lines("GOT10k/test/list.txt", names)
    W, H = w.wh("got10k")
    for name in ("GOT-10k_Val_000001", "GOT-10k_Val_000002"):
        seed, gt = w.sequence("got10k", [f"GOT10k/val/{name}/{i:08d}.jpg"
                                         for i in range(1, w.frames + 1)])
        w.text(f"GOT10k/val/{name}/groundtruth.txt", gt, fmt="%.4f")
        if name.endswith("1"):
            imwrite_indexed(w.path("GOT10k_masks", name, "00000001.png"),
                            vos_mask(seed, 0, W, H, 1))
    return {"got10k_path": os.path.join(w.root, "GOT10k"),
            "got10k_mask_path": os.path.join(w.root, "GOT10k_masks")}


def _trackingnet(w):
    W, H = w.wh("trackingnet")
    for name in ("-3TIfnTSM6c_2", "0-6LB4FqxoE_0"):
        seed, gt = w.sequence("trackingnet", [f"TrackingNet/TEST/frames/{name}/{i}.jpg"
                                              for i in range(w.frames)])
        w.text(f"TrackingNet/TEST/anno/{name}.txt", gt[:1])
        imwrite_indexed(w.path("TrackingNet_masks", name, "0.png"), vos_mask(seed, 0, W, H, 1))
    return {"trackingnet_path": os.path.join(w.root, "TrackingNet"),
            "trackingnet_mask_path": os.path.join(w.root, "TrackingNet_masks")}


def rotated_polygons(boxes, angle=0.3):
    """(N, 8) corners of each box turned by `angle` about its centre: VOT's
    polygon annotations."""
    boxes = np.asarray(boxes, np.float64)
    c = boxes[:, :2] + boxes[:, 2:] / 2
    half = boxes[:, 2:] / 2
    corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
    rot = np.array([[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]])
    pts = (corners[None] * half[:, None]) @ rot.T + c[:, None]
    return pts.reshape(len(boxes), 8)


def _vot(w):
    _, gt = w.sequence("vot", [f"VOT/ants1/color/{i:08d}.jpg"
                               for i in range(1, w.count("vot", True) + 1)])
    w.text("VOT/ants1/groundtruth.txt", rotated_polygons(gt), fmt="%.4f")
    _, gt = w.sequence("vot", [f"VOT/bag/{i:08d}.jpg" for i in range(1, w.frames + 1)])
    w.text("VOT/bag/groundtruth.txt", gt)
    _, gt = w.sequence("vot", [f"VOT/unlisted/{i:08d}.jpg" for i in range(1, w.frames + 1)])
    w.text("VOT/unlisted/groundtruth.txt", gt)
    w.lines("VOT/list.txt", ["ants1", "bag"])
    return {"vot_path": os.path.join(w.root, "VOT")}


def _avist(w):
    for name in ("air_show", "airplane_in_rain"):
        n = w.frames
        _, gt = w.sequence("avist", [f"AVisT/sequences/{name}/{i:05d}.jpg"
                                     for i in range(1, n + 1)])
        w.text(f"AVisT/anno/{name}.txt", gt)
        if name == "air_show":
            w.text(f"AVisT/full_occlusion/{name}.txt", np.eye(1, n, 1), fmt="%d")
            w.text(f"AVisT/out_of_view/{name}.txt", np.zeros((1, n)), fmt="%d")
    w.text("AVisT/anno/no_frames.txt", [[1, 2, 3, 4]])
    return {"avist_path": os.path.join(w.root, "AVisT")}


def _tpl(w):
    n = w.frames
    _, gt = w.sequence("tpl", [f"TC128/Basketball/img/{i:04d}.jpg" for i in range(1, n + 1)])
    w.text("TC128/Basketball/Basketball_gt.txt", gt)
    # Airport_ce's frames 2..n+1 of its folder, named in its frames file
    _, gt = w.sequence("tpl", [f"TC128/Airport_ce/img/{i:04d}.jpg" for i in range(1, n + 2)])
    w.text("TC128/Airport_ce/Airport_ce_gt.txt", gt[1:])
    w.text("TC128/Airport_ce/Airport_ce_frames.txt", [[2, n + 1]], fmt="%d")
    return {"tpl_path": os.path.join(w.root, "TC128")}


def _davis(w):
    W, H = w.wh("davis")
    seqs = {"bike-packing": 2, "blackswan": 1, "aerobatics": 2, "acrobatics": 1}
    for k, (name, objects) in enumerate(seqs.items()):
        n = w.count("davis", k == 0)
        seed, _ = w.sequence("davis", [f"DAVIS/JPEGImages/480p/{name}/{i:05d}.jpg"
                                       for i in range(n)])
        annotated = n if name in ("bike-packing", "blackswan") else 1   # the test splits: 1
        for t in range(annotated):
            imwrite_indexed(w.path("DAVIS/Annotations/480p", name, f"{t:05d}.png"),
                            vos_mask(seed, t, W, H, objects))
    w.lines("DAVIS/ImageSets/2017/val.txt", ["bike-packing", "blackswan"])
    w.lines("DAVIS/ImageSets/2016/val.txt", ["blackswan"])
    w.lines("DAVIS/ImageSets/2017/test-dev.txt", ["aerobatics"])
    w.lines("DAVIS/ImageSets/2017/test-challenge.txt", ["acrobatics"])
    return {"davis_dir": os.path.join(w.root, "DAVIS")}


def _youtubevos_split(w, version, split, videos, all_masks):
    """videos: {name: (its first frame's number, {object id: index of the
    annotated frame it starts at}, how many annotated frames from the first
    are unlabelled)}. Every 5th frame is annotated (the split's JPEGImages,
    named by number); the all-frames folder holds every frame, each
    annotated one followed by copies of it. Label maps hold the objects
    that start on the frame, or with all_masks every object present."""
    import shutil

    W, H = w.wh("youtubevos")
    base = f"YouTubeVOS/{version}/{split}"
    meta = {}
    for name, (first_number, starts, unlabelled) in videos.items():
        numbers = [first_number + 5 * k for k in range(w.frames)]
        seed, _ = w.sequence("youtubevos", [f"{base}/JPEGImages/{name}/{t:05d}.jpg"
                                            for t in numbers])
        for t in range(first_number, numbers[-1] + 1):
            src = numbers[(t - first_number) // 5]
            shutil.copyfile(w.path(f"{base}/JPEGImages/{name}/{src:05d}.jpg"),
                            w.path(f"{base}_all_frames/JPEGImages/{name}/{t:05d}.jpg"))
        meta[name] = {"objects": {oid: {"category": "thing",
                                        "frames": [f"{t:05d}" for t in numbers[first:]]}
                                  for oid, first in starts.items()}}
        for k, t in enumerate(numbers):   # sparse splits label each object where it starts
            present = [int(oid) for oid, first in starts.items()
                       if first == k or (all_masks and first < k)]
            if not present:
                continue
            m = vos_mask(seed, k, W, H, 2)
            m[~np.isin(m, present) | (k < unlabelled)] = 0
            imwrite_indexed(w.path(f"{base}/Annotations/{name}/{t:05d}.png"), m)
    with open(w.path(f"{base}/meta.json"), "w") as f:
        json.dump({"videos": meta}, f)


def _youtubevos(w):
    # 0a49f5265b's object 2 starts at its second annotated frame; in the
    # train folder 0e27472bea's object 2 is listed from 00055, but 00055 and
    # 00060 are unlabelled (the 'starts' cleanup starts it at 00065); the jj
    # split holds 0e27472bea alone
    valid = {"0a49f5265b": (0, {"1": 0, "2": 1}, 0), "3e03f623bb": (0, {"1": 0}, 0)}
    train = {"0e27472bea": (55, {"2": 0}, 2), "othervid": (0, {"1": 0}, 0)}
    for version in ("2019", "2018"):
        _youtubevos_split(w, version, "valid", valid, False)
        _youtubevos_split(w, version, "train", train, True)
    _youtubevos_split(w, "2019", "test", {"0b6f9105fc": (0, {"1": 0, "2": 2}, 0)}, False)
    return {"youtubevos_dir": os.path.join(w.root, "YouTubeVOS")}


def _oxuva(w):
    W, H = w.wh("oxuva")
    rows = {"dev": [], "test": []}
    annos = []
    for split, vid in (("dev", "vid0001"), ("dev", "vid0002"), ("test", "vid0101")):
        n = w.frames
        _, gt = w.sequence("oxuva", [f"OxUvA/images/{split}/{vid}/{t:06d}.jpeg"
                                     for t in range(n)])
        x0, y0 = gt[0, 0] / W, gt[0, 1] / H
        x1, y1 = (gt[0, 0] + gt[0, 2]) / W, (gt[0, 1] + gt[0, 3]) / H
        rows[split].append(f"{vid},obj0,0,{n - 1},{x0:.6f},{x1:.6f},{y0:.6f},{y1:.6f}")
        if split == "dev":
            for t in range(0, n, 2):          # every other frame annotated
                b = gt[t]
                annos.append(f"{vid},obj0,1,person,False,True,{t},present,"
                             f"{b[0] / W:.6f},{(b[0] + b[2]) / W:.6f},"
                             f"{b[1] / H:.6f},{(b[1] + b[3]) / H:.6f}")
    w.lines("OxUvA/tasks/dev.csv", rows["dev"])
    w.lines("OxUvA/tasks/test.csv", rows["test"])
    w.lines("OxUvA/annotations/dev.csv", annos)
    return {"oxuva_path": os.path.join(w.root, "OxUvA")}


def _mobiface(w):
    for split, names in (("train", ["face_a", "face_b"]), ("test", ["face_c"])):
        for name in names:
            n = w.frames
            _, gt = w.sequence("mobiface", [f"MobiFace/{split}/{name}/{t:06d}.jpg"
                                            for t in range(n)])
            w.text(f"MobiFace/{split}/{name}.annot.csv", np.c_[np.arange(n), gt.astype(int)],
                   fmt="%d", header="frame,x,y,w,h")
        w.lines(f"MobiFace/{split}.meta.csv", ["name,fps"] + [f"{n},30" for n in names])
    return {"mobiface_path": os.path.join(w.root, "MobiFace")}


def _lagot(w, lasot_path):
    """LaGOT's annotations over the LaSOT tree's lion-3 and person-20."""
    multi, single = {}, {}
    for rel in ("lion/lion-3", "person/person-20"):
        name = os.path.basename(rel)
        gt = np.loadtxt(os.path.join(lasot_path, rel, "groundtruth.txt"), delimiter=",",
                        ndmin=2)
        n = len(gt)
        frames = [f"{rel}/img/{i:08d}.jpg" for i in range(1, n + 1)]
        second = gt + [40, 20, 0, 0]
        second[0] = -1                        # the second track starts later
        multi[name] = {"frames": frames, "xywh": {"1": gt.tolist(), "2": second.tolist()}}
        one = gt.copy()
        one[3 % n] = -1                       # an annotated frame (every third) without it
        single[f"{name}_1"] = {"frames": frames, "xywh": one.tolist()}
    with open(w.path("LaGOT", "LaGOT_multiple_object_per_sequence_annotations_final.json"),
              "w") as f:
        json.dump(multi, f)
    with open(w.path("LaGOT", "LaGOT_one_object_per_sequence_annotations_final.json"),
              "w") as f:
        json.dump(single, f)
    return {"lagot_path": os.path.join(w.root, "LaGOT")}
