"""Small trees in the on-disk layouts of the training datasets the readers
of training/datasets/ take (LaSOT, GOT-10k, TrackingNet, COCO and LVIS,
ImageNet-VID, TAO-BURST, DAVIS, YouTube-VOS, the GOT-10k and LaSOT
pseudo-masks, ECSSD, MSRA10k, HKU-IS, SBD) with the upstream split files,
for training where the datasets are not on disk.

    paths = write_training_trees("/tmp/train_trees")
    os.environ.update(environment_variables(paths))
    Lasot(paths["lasot"], split="train")

Frames are the synthetic renderer's (a moving square over a textured
background and two static distractors), written as JPEG by OpenCV through
evaluation/benchmark_trees.py's writer, at each dataset's usual frame size
unless `size` is given; the boxes are the square's and the first
distractor's (its pixels the square leaves visible), label maps indexed
PNGs (utils/png_io) of the two, the saliency masks greyscale PNGs. Each
tree holds its reader's irregular cases: frames out of view, absent or
uncovered, a TrackingNet set missing, COCO crowd, tiny and run-length
encoded instances and an image without any, ImageNet-VID and TAO-BURST
tracks that end or pause, a saliency image without a mask.
"""

from __future__ import annotations

import json
import os

import numpy as np

from pytracking_tpu_torch.evaluation.benchmark_trees import _lasot_sequence, _Writer, vos_mask
from pytracking_tpu_torch.training.datasets.vos_base import _mask_to_bbox
from pytracking_tpu_torch.utils.png_io import imwrite_indexed

# (width, height) of each dataset's frames
FRAME_SIZES = {"lasot": (1280, 720), "got10k": (1280, 720), "trackingnet": (1280, 720),
               "youtubevos": (1280, 720), "imagenet_vid": (1280, 720),
               "taoburst": (1280, 720), "davis": (854, 480), "coco": (640, 480),
               "seg": (400, 300)}
TREES = ("lasot", "got10k", "trackingnet", "coco", "imagenet_vid", "taoburst", "davis",
         "youtubevos", "seg")


class _TrainWriter(_Writer):
    def wh(self, bench):
        return self.size or FRAME_SIZES[bench]

    def labels(self, seed, t, bench, objects=2):
        """Frame t's label map (the square 1, the distractor 2) and the
        two objects' boxes from their visible pixels."""
        W, H = self.wh(bench)
        m = vos_mask(seed, t, W, H, objects)
        return m, [_mask_to_bbox(m == k).astype(np.float64) for k in range(1, objects + 1)]


def write_training_trees(root: str, frames: int = 30, size=None, trees=TREES) -> dict:
    """Write the trees named in `trees` under `root`; returns {reader: root
    path} (the readers' names; 'lasot_masks' / 'got10k_masks' the
    pseudo-mask trees) with 'data_specs_path', the upstream split files
    (lasot_train_split.txt, got10k_{train,val,vot_train,vot_val}_split.txt).
    frames: frames per video sequence (at least 8); size: (W, H) of every
    frame, None for each dataset's own."""
    from concurrent.futures import ThreadPoolExecutor

    if frames < 8:
        raise ValueError("the training trees need 8 frames per sequence or more")

    def write(k, name):
        w = _TrainWriter(root, frames, size, None)
        w.seed = 1000 * k                 # each tree's own seeds: the trees are written at once
        return globals()["_" + name](w)

    paths = {}
    with ThreadPoolExecutor(len(trees)) as pool:      # OpenCV and zlib release the GIL
        for p in pool.map(write, range(len(trees)), trees):
            paths.update(p)
    w = _TrainWriter(root, frames, size, None)
    w.lines("data_specs/lasot_train_split.txt", ["airplane-1", "bird-1"])
    for split, ids in (("train", [0, 1, 2]), ("val", [2]), ("vot_train", [0, 2]),
                       ("vot_val", [1])):
        w.lines(f"data_specs/got10k_{split}_split.txt", [str(i) for i in ids])
    paths["data_specs_path"] = os.path.join(w.root, "data_specs")
    return paths


def environment_variables(paths: dict) -> dict:
    """The variables that point the evaluation harness's `lasot_train` (the
    distractor dump's dataset) at the LaSOT tree, and both packages at the
    split files."""
    env = {"PYTRACKING_TPU_DATA_SPECS_PATH": paths["data_specs_path"]}
    if "lasot" in paths:
        env["PYTRACKING_TPU_LASOT_PATH"] = paths["lasot"]
    return env


def _lasot(w):
    W, H = w.wh("lasot")
    seeds = {}
    for rel in ("airplane/airplane-1", "airplane/airplane-2", "bird/bird-1"):
        _, seeds[rel], _ = _lasot_sequence(w, "LaSOT", rel, "lasot", False, True)
    for t in range(2):             # the first two frames of airplane-1 have pseudo-masks
        imwrite_indexed(w.path("LaSOT_masks", "airplane", "airplane-1", f"{t + 1:08d}.png"),
                        vos_mask(seeds["airplane/airplane-1"], t, W, H, 1))
    return {"lasot": os.path.join(w.root, "LaSOT"),
            "lasot_masks": os.path.join(w.root, "LaSOT_masks")}


def _got10k(w):
    W, H = w.wh("got10k")
    n = w.frames
    names = [f"GOT-10k_Train_{i:06d}" for i in range(1, 4)]
    for k, name in enumerate(names):
        seed, gt = w.sequence("got10k", [f"GOT10k/train/{name}/{i:08d}.jpg"
                                         for i in range(1, n + 1)])
        w.text(f"GOT10k/train/{name}/groundtruth.txt", gt, fmt="%.4f")
        absence = np.zeros((n, 1), int)
        absence[2] = 1
        cover = np.full((n, 1), 8 - k)
        cover[3] = 0
        w.text(f"GOT10k/train/{name}/absence.label", absence, fmt="%d")
        w.text(f"GOT10k/train/{name}/cover.label", cover, fmt="%d")
        if k == 0:
            for t in range(2):
                imwrite_indexed(w.path("GOT10k_masks", name, f"{t + 1:08d}.png"),
                                vos_mask(seed, t, W, H, 1))
    w.lines("GOT10k/train/list.txt", names)
    return {"got10k": os.path.join(w.root, "GOT10k", "train"),
            "got10k_masks": os.path.join(w.root, "GOT10k_masks")}


def _trackingnet(w):
    # TRAIN_2 is absent: the reader passes over a set that is not on disk
    for sid, name in ((0, "0-6LB4FqxoE_0"), (1, "-3TIfnTSM6c_2"), (3, "Aa5TTRhwcVg_1")):
        _, gt = w.sequence("trackingnet", [f"TrackingNet/TRAIN_{sid}/frames/{name}/{i}.jpg"
                                           for i in range(w.frames)])
        w.text(f"TrackingNet/TRAIN_{sid}/anno/{name}.txt", gt)
    return {"trackingnet": os.path.join(w.root, "TrackingNet")}


def _octagon(box):
    """The box with its corners cut by a quarter of its sides, as a COCO
    polygon."""
    x, y, bw, bh = box
    cx, cy = bw / 4, bh / 4
    pts = [(x + cx, y), (x + bw - cx, y), (x + bw, y + cy), (x + bw, y + bh - cy),
           (x + bw - cx, y + bh), (x + cx, y + bh), (x, y + bh - cy), (x, y + cy)]
    return [round(float(v), 2) for p in pts for v in p]


def _coco(w):
    images, annos, ann_id = [], [], 1
    for k in range(4):
        file_name = f"{9 + k:012d}.jpg"
        seed, _ = w.sequence("coco", [f"COCO/train2017/{file_name}"])
        W, H = w.wh("coco")
        images.append({"id": 9 + k, "file_name": file_name, "height": H, "width": W,
                       "coco_url": f"http://images.cocodataset.org/train2017/{file_name}"})
        if k == 3:
            continue                             # an image without instances
        _, (square, distractor) = w.labels(seed, 0, "coco")
        x, y, bw, bh = distractor
        instances = [(1, square, [_octagon(square)], 0),
                     (2, distractor, [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]], 0)]
        if k == 0:                               # run-length encoded: the box stands in
            instances.append((2, np.array([20.0, 30.0, 40.0, 25.0]),
                              {"counts": [3000, 40, 600], "size": [H, W]}, 0))
        if k == 1:                               # a crowd, and an instance under 50 pixels
            instances.append((1, np.array([100.0, 100.0, 60.0, 60.0]),
                              [_octagon([100.0, 100.0, 60.0, 60.0])], 1))
            instances.append((1, np.array([5.0, 5.0, 6.0, 7.0]),
                              [_octagon([5.0, 5.0, 6.0, 7.0])], 0))
        for cat, box, seg, crowd in instances:
            annos.append({"id": ann_id, "image_id": 9 + k, "category_id": cat,
                          "bbox": [round(float(v), 2) for v in box],
                          "area": float(box[2] * box[3]), "iscrowd": crowd,
                          "segmentation": seg})
            ann_id += 1
    cats = [{"id": 1, "name": "square"}, {"id": 2, "name": "distractor"}]
    with open(w.path("COCO", "annotations", "instances_train2017.json"), "w") as f:
        json.dump({"images": images, "annotations": annos, "categories": cats}, f)
    lvis = [{k: v for k, v in a.items() if k != "iscrowd"} for a in annos]
    with open(w.path("COCO", "lvis_v1_train.json"), "w") as f:
        json.dump({"images": images, "annotations": lvis, "categories": cats}, f)
    return {"coco": os.path.join(w.root, "COCO"), "lvis": os.path.join(w.root, "COCO")}


def _vid_xml(objects):
    """A frame's ImageNet-VID annotation: objects (track id, box, occluded)."""
    rows = ["<annotation>"]
    for tid, (x, y, bw, bh), occluded in objects:
        rows += ["  <object>", f"    <trackid>{tid}</trackid>", "    <name>n02691156</name>",
                 "    <bndbox>", f"      <xmax>{int(x + bw)}</xmax>", f"      <xmin>{int(x)}</xmin>",
                 f"      <ymax>{int(y + bh)}</ymax>", f"      <ymin>{int(y)}</ymin>",
                 "    </bndbox>", f"    <occluded>{occluded}</occluded>",
                 "    <generated>0</generated>", "  </object>"]
    return rows + ["</annotation>"]


def _imagenet_vid(w):
    import shutil

    n = w.frames
    set_name = "ILSVRC2015_VID_train_0000"
    for v in range(2):
        vid = f"ILSVRC2015_train_{v:08d}"
        # cv2 picks its encoder by the extension: written as .jpg, renamed to .JPEG
        rels = [f"ImageNetVID/Data/VID/train/{set_name}/{vid}/{t:06d}.jpg" for t in range(n)]
        seed, _ = w.sequence("imagenet_vid", rels)
        for rel in rels:
            shutil.move(w.path(rel), w.path(rel[:-4] + ".JPEG"))
        for t in range(n):
            _, (square, distractor) = w.labels(seed, t, "imagenet_vid")
            objects = [(0, square, int(t == 3))]
            if v == 1 or 2 <= t < n - 3:         # video 0's track 1 ends 3 frames early
                objects.append((1, distractor, 0))
            w.lines(f"ImageNetVID/Annotations/VID/train/{set_name}/{vid}/{t:06d}.xml",
                    _vid_xml(objects))
    return {"imagenet_vid": os.path.join(w.root, "ImageNetVID")}


def _taoburst(w):
    n = w.frames
    annos = {}
    for dataset_name, seq_name in (("YFCC100M", "v_25685519b728afd746dfd1b2fe77c"),
                                   ("LaSOT", "zebra-17")):
        paths = [f"frame{t * 30:04d}.jpg" for t in range(n)]
        seed, _ = w.sequence("taoburst", [f"TAO/annotated_frames/train/{dataset_name}/"
                                          f"{seq_name}/{p}" for p in paths])
        per_frame = []
        for t in range(n):
            _, (square, distractor) = w.labels(seed, t, "taoburst")
            d = {"1": [round(float(v), 2) for v in square]}
            if t % 5 != 4:                       # track 2 is absent every fifth frame
                d["2"] = [round(float(v), 2) for v in distractor]
            per_frame.append(d)
        annos[f"train/{dataset_name}/{seq_name}"] = {
            "split": "train", "dataset_name": dataset_name, "seq_name": seq_name,
            "annotated_image_paths": paths, "track_ids": [1, 2], "annotations": per_frame}
    with open(w.path("TAO", "TaoBurst.json"), "w") as f:
        json.dump(annos, f)
    return {"taoburst": os.path.join(w.root, "TAO")}


def _label_maps(w, bench, seed, rels, objects):
    for t, rel in enumerate(rels):
        m, _ = w.labels(seed, t, bench, objects)
        imwrite_indexed(w.path(rel), m)


def _davis(w):
    n = w.frames
    for name, objects in (("bmx-bumps", 2), ("bear", 1)):
        seed, _ = w.sequence("davis", [f"DAVIS/JPEGImages/480p/{name}/{t:05d}.jpg"
                                       for t in range(n)])
        _label_maps(w, "davis", seed, [f"DAVIS/Annotations/480p/{name}/{t:05d}.png"
                                       for t in range(n)], objects)
    w.lines("DAVIS/ImageSets/2017/train.txt", ["bmx-bumps", "bear"])
    return {"davis": os.path.join(w.root, "DAVIS")}


def _youtubevos(w):
    n = w.frames
    base = "YouTubeVOS/2019/train"
    for name, objects in (("003234408d", 2), ("0043f083b5", 1)):
        numbers = [5 * k for k in range(n)]       # every 5th frame is annotated
        seed, _ = w.sequence("youtubevos", [f"{base}/JPEGImages/{name}/{t:05d}.jpg"
                                            for t in numbers])
        _label_maps(w, "youtubevos", seed, [f"{base}/Annotations/{name}/{t:05d}.png"
                                            for t in numbers], objects)
    return {"youtubevos": os.path.join(w.root, "YouTubeVOS")}


def _seg(w):
    """ECSSD, MSRA10k, HKU-IS and SBD: two images each with greyscale masks
    of the square (0 / 255), ECSSD with a third image without a mask and a
    fourth whose mask is under the readers' 100 pixels."""
    import cv2

    paths = {}
    for name, image_dir, mask_dir in (("ECSSD", "images", "ground_truth_mask"),
                                      ("MSRA10k", "Imgs", "Imgs"), ("HKUIS", "imgs", "gt"),
                                      ("SBD", "img", "masks")):
        count = 4 if name == "ECSSD" else 2
        for k in range(count):
            seed, _ = w.sequence("seg", [f"{name}/{image_dir}/{k:04d}.jpg"])
            if k == 2:
                continue
            m, _ = w.labels(seed, 0, "seg", 1)
            m = (m == 1).astype(np.uint8) * 255
            if k == 3:
                m[:] = 0
                m[10:18, 10:18] = 255
            if not cv2.imwrite(w.path(f"{name}/{mask_dir}/{k:04d}.png"), m):
                raise OSError(f"cv2.imwrite failed for {name}/{mask_dir}/{k:04d}.png")
        paths[name.lower()] = os.path.join(w.root, name)
    return paths
