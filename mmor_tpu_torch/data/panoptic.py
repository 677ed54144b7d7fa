"""Panoptic data layer: class metadata, mask processing, video records.

Copy of ``mmor_tpu/data/panoptic.py``: the port imports nothing of the JAX
package, so it keeps its own copy of the host code it uses. The 4D-OR and
hybrid datasets are not copied (training slice).

Parity with the reference dataset base + adapters
(`panoptic_segmentation/datasets/{or_dataset,mmor_dataset,or4d_dataset,hybrid_dataset}.py`):

- 24 foreground classes with fixed label values and display colors
  (``TRACK_TO_METAINFO``, or_dataset.py:15-47); GT masks store the raw label
  value per pixel;
- ``clean_mask`` removes small connected components (or_dataset.py:50-85;
  scipy.ndimage stands in for cv2 contours — the area measure is pixel count);
- ``process_panoptic_mask`` maps labels to contiguous category ids (skipping
  the LIKELY_MISTAKES artifacts) and encodes panoptic ids as
  ``category_id * 10 + instance_id`` (or_dataset.py:101-103, 154-172);
- videos longer than ``max_video_length`` chunk with overlap
  (or_dataset.py:121-137); processed per-take/cam records cache as npz;
- ``id2rgb``/``rgb2id`` implement the panopticapi color codec used by the
  eval dumps (vps_eval.py:206-235).
"""

from __future__ import annotations

import json
from collections import OrderedDict
from pathlib import Path

import numpy as np
from PIL import Image

TRACK_TO_METAINFO = {
    "instrument_table": {"color": (255, 51, 153), "label": 1},
    "ae": {"color": (0, 0, 255), "label": 2},
    "ot": {"color": (255, 255, 0), "label": 3},
    "mps_station": {"color": (133, 0, 133), "label": 4},
    "patient": {"color": (255, 0, 0), "label": 5},
    "drape": {"color": (183, 91, 255), "label": 6},
    "anest": {"color": (177, 255, 110), "label": 7},
    "circulator": {"color": (255, 128, 0), "label": 8},
    "assistant_surgeon": {"color": (116, 166, 116), "label": 9},
    "head_surgeon": {"color": (76, 161, 245), "label": 10},
    "mps": {"color": (125, 100, 25), "label": 11},
    "nurse": {"color": (128, 255, 0), "label": 12},
    "drill": {"color": (0, 255, 128), "label": 13},
    "hammer": {"color": (204, 0, 0), "label": 15},
    "saw": {"color": (0, 255, 234), "label": 16},
    "tracker": {"color": (255, 128, 128), "label": 17},
    "mako_robot": {"color": (60, 75, 255), "label": 18},
    "monitor": {"color": (255, 255, 128), "label": 24},
    "c_arm": {"color": (0, 204, 128), "label": 25},
    "unrelated_person": {"color": (255, 255, 255), "label": 26},
    "student": {"color": (162, 232, 108), "label": 27},
    "secondary_table": {"color": (153, 0, 153), "label": 28},
    "cementer": {"color": (153, 76, 0), "label": 29},
    "__background__": {"color": (0, 0, 0), "label": 0},
}

SORTED_CLASSES = sorted(TRACK_TO_METAINFO, key=lambda k: TRACK_TO_METAINFO[k]["label"])
LABEL_TO_CATEGORY_ID = {
    TRACK_TO_METAINFO[name]["label"]: i for i, name in enumerate(SORTED_CLASSES)
}
# mislabeled artifacts silently skipped (or_dataset.py:154)
LIKELY_MISTAKES = {19, 20, 14, 22, 23}

LABEL_DIVISOR = 10


def categories() -> dict[int, dict]:
    """Contiguous-id category table (isthing=1 for all, mmor_dataset.py:113)."""
    return {
        i: {"id": i, "name": name, "isthing": 1,
            "color": TRACK_TO_METAINFO[name]["color"]}
        for i, name in enumerate(SORTED_CLASSES)
    }


def encode_panoptic(category_id: int, instance_id: int) -> int:
    return category_id * LABEL_DIVISOR + instance_id


def decode_panoptic(panoptic_id):
    return panoptic_id // LABEL_DIVISOR, panoptic_id % LABEL_DIVISOR


def id2rgb(id_map: np.ndarray) -> np.ndarray:
    """Panoptic id -> RGB (panopticapi codec: id = R + G*256 + B*256^2)."""
    id_map = np.asarray(id_map, dtype=np.uint32)
    return np.stack(
        [id_map % 256, (id_map // 256) % 256, (id_map // 65536) % 256], axis=-1
    ).astype(np.uint8)


def rgb2id(color: np.ndarray) -> np.ndarray:
    color = np.asarray(color, dtype=np.uint32)
    return color[..., 0] + color[..., 1] * 256 + color[..., 2] * 65536


def clean_mask(mask: np.ndarray, area_threshold: int = 10) -> np.ndarray:
    """Drop connected components smaller than ``area_threshold`` pixels."""
    from scipy import ndimage

    out = mask.copy()
    for label in np.unique(mask):
        if label == 0:
            continue
        binary = mask == label
        comps, n = ndimage.label(binary)
        if n == 0:
            continue
        sizes = ndimage.sum_labels(binary, comps, index=np.arange(1, n + 1))
        for comp_idx in np.nonzero(sizes < area_threshold)[0]:
            out[comps == comp_idx + 1] = 0
    return out


def load_label_mask(path: str | Path) -> np.ndarray:
    """GT masks store the raw label value per pixel (possibly replicated
    across RGB channels); returns (H, W) uint8."""
    arr = np.asarray(Image.open(path))
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.uint8)


def _resize_nearest(mask: np.ndarray, size_wh: tuple[int, int]) -> np.ndarray:
    return np.asarray(
        Image.fromarray(mask).resize(size_wh, Image.NEAREST)
    )


def process_panoptic_mask(
    label_mask: np.ndarray,
    image_res: tuple[int, int] | None = None,
    area_threshold: int = 10,
):
    """label map -> (segments_info, panoptic_seg, category_seg).

    panoptic_seg holds ``category_id * 10 + instance_id`` per pixel (instance
    id is 0 — one instance per class, like the reference); category_seg holds
    the category id (the *_for_val map).
    """
    mask = clean_mask(label_mask, area_threshold)
    if image_res is not None:
        mask = _resize_nearest(mask, image_res)
    segments_info = []
    panoptic_seg = np.zeros_like(mask, dtype=np.int32)
    category_seg = np.zeros_like(mask, dtype=np.int32)
    for label in np.unique(mask):
        if label == 0:
            continue
        category_id = LABEL_TO_CATEGORY_ID.get(int(label))
        if category_id is None:
            continue  # artifacts / unknown labels skipped (or_dataset.py:154-172)
        pan_id = encode_panoptic(category_id, 0)
        instance = mask == label
        ys, xs = np.nonzero(instance)
        segments_info.append({
            "id": pan_id,
            "category_id": category_id,
            "area": int(instance.sum()),
            "bbox": (int(xs.min()), int(ys.min()),
                     int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)),
            "isthing": 0,
            "iscrowd": 0,
            "rgb2idcolor": int(rgb2id(np.array(
                TRACK_TO_METAINFO[SORTED_CLASSES[category_id]]["color"]
            ))),
        })
        panoptic_seg[instance] = pan_id
        category_seg[instance] = category_id
    return segments_info, panoptic_seg, category_seg


def split_video_samples(
    samples: "OrderedDict[str, list]", max_video_length: int | None, overlap: int
) -> "OrderedDict[str, list]":
    """Chunk long videos to ``max_video_length`` with ``overlap`` frames
    (or_dataset.py:121-137)."""
    if max_video_length is None:
        return samples
    out: OrderedDict[str, list] = OrderedDict()
    for key, frames in samples.items():
        if len(frames) <= max_video_length:
            out[key] = frames
            continue
        step = max_video_length - overlap
        for start in range(0, len(frames), step):
            out[f"{key}_part{start // step}"] = frames[start: start + max_video_length]
    return out


class MMORPanopticDataset:
    """MM-OR video panoptic records: azure cams 1/4/5 + simstation cams 0/2/3
    (mmor_dataset.py:17-202). Produces per-video dicts of frame paths, mask
    paths and segment infos, with npz caching of the processed metadata."""

    AZURE_CAMS = (1, 4, 5)
    SIMSTATION_CAMS = (0, 2, 3)
    IMAGE_RES = (2048, 1536)

    def __init__(
        self,
        root_dir: str | Path,
        split: str = "train",
        cache_dir: str | Path | None = None,
        max_video_length: int | None = 200,
        overlap: int = 3,
    ):
        from mmor_tpu_torch.data.configurations import (
            MMOR_SPLIT_TO_TAKES,
            MMOR_TAKE_NAME_TO_FOLDER,
            MMOR_TAKE_NAMES,
        )

        self.root_dir = Path(root_dir)
        self.split = split
        self.cache_dir = Path(cache_dir) if cache_dir else self.root_dir / "mm-or_cache"
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.categories = categories()

        self.samples: OrderedDict[str, list] = OrderedDict()
        take_jsons = self.root_dir / "take_jsons"
        for take in MMOR_TAKE_NAMES:
            if take not in MMOR_SPLIT_TO_TAKES[split]:
                continue
            tj = take_jsons / f"{take}.json"
            if not tj.exists():
                continue
            folder = self.root_dir / MMOR_TAKE_NAME_TO_FOLDER.get(take, take)
            data = json.loads(tj.read_text())
            stamps = sorted(data["timestamps"].items(), key=lambda kv: int(kv[0]))
            for cam in self.AZURE_CAMS:
                frames = []
                for _ts, info in stamps:
                    rgb = folder / "colorimage" / f'camera0{cam}_colorimage-{info["azure"]}.jpg'
                    mask = folder / f"segmentation_export_{cam}" / f"{rgb.stem}.png"
                    if mask.exists():
                        frames.append({"rgb": rgb, "mask": mask})
                if frames:
                    self.samples[f"{take}_{cam}"] = frames
            for cam in self.SIMSTATION_CAMS:
                frames = []
                for _ts, info in stamps:
                    rgb = folder / "simstation" / f'camera0{cam}_{info["simstation"]}.jpg'
                    mask = folder / f"simstation_segmentation_export_{cam}" / f"{rgb.stem}.png"
                    if mask.exists():
                        frames.append({"rgb": rgb, "mask": mask})
                if frames:
                    self.samples[f"{take}_simstation{cam}"] = frames
        self.samples = split_video_samples(self.samples, max_video_length, overlap)

    def __len__(self) -> int:
        return len(self.samples)

    def video_records(self):
        """Yield processed per-video records (cached as npz per video)."""
        for video_id, frames in self.samples.items():
            cache = self.cache_dir / f"{video_id}.npz"
            if cache.exists():
                data = np.load(cache, allow_pickle=True)
                yield {
                    "video_id": video_id,
                    "file_names": data["file_names"].tolist(),
                    "segments_infos": data["segments_infos"].tolist(),
                    "pan_seg": data["pan_seg"],
                    "category_seg": data["category_seg"],
                }
                continue
            file_names, seg_infos, pans, cats = [], [], [], []
            for frame in frames:
                mask = load_label_mask(frame["mask"])
                info, pan, cat = process_panoptic_mask(mask, self.IMAGE_RES)
                file_names.append(str(frame["rgb"]))
                seg_infos.append(info)
                pans.append(pan)
                cats.append(cat)
            pans = np.stack(pans)
            cats = np.stack(cats)
            np.savez_compressed(
                cache,
                file_names=np.array(file_names),
                segments_infos=np.array(seg_infos, dtype=object),
                pan_seg=pans,
                category_seg=cats,
            )
            yield {
                "video_id": video_id,
                "file_names": file_names,
                "segments_infos": seg_infos,
                "pan_seg": pans,
                "category_seg": cats,
            }
