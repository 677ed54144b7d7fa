"""Video Panoptic Quality (VPQ) — tube matching over sliding windows.

Copy of ``mmor_tpu/eval/vpq.py``: the port imports nothing of the JAX
package, so it keeps its own copy of the host code it uses.

Equivalent of the reference ``eval_vpq_vspw.py`` (`utils/eval_vpq_vspw.py`):
for every ``nframes``-long window, GT and predicted panoptic id maps are
concatenated into tubes; tubes match when same-category IoU > 0.5 (VOID
pixels excluded from the union); per-category TP/IoU/FP/FN accumulate into
PQ = ΣIoU / (TP + FP/2 + FN/2), with crowd handling and the >50%-VOID FP
exclusion. Operates on in-memory id maps + segment infos (PNG color codec
lives in the data layer); parallelism over videos via multiprocessing, like
the reference's ``vpq_compute_parallel``.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

VOID = 0
_OFFSET = 1 << 32


@dataclass
class PQStatCat:
    iou: float = 0.0
    tp: int = 0
    fp: int = 0
    fn: int = 0

    def __iadd__(self, other: "PQStatCat") -> "PQStatCat":
        self.iou += other.iou
        self.tp += other.tp
        self.fp += other.fp
        self.fn += other.fn
        return self


@dataclass
class PQStat:
    per_cat: dict[int, PQStatCat] = field(default_factory=lambda: defaultdict(PQStatCat))

    def __getitem__(self, cat: int) -> PQStatCat:
        return self.per_cat[cat]

    def __iadd__(self, other: "PQStat") -> "PQStat":
        for cat, stat in other.per_cat.items():
            self.per_cat[cat] += stat
        return self

    def average(self, categories: Mapping[int, Mapping], isthing: bool | None = None):
        """PQ/SQ/RQ/precision/recall averaged over categories with support."""
        sums = defaultdict(float)
        per_class = {}
        n = 0
        for cat, info in categories.items():
            if isthing is not None and bool(info["isthing"]) != isthing:
                continue
            s = self.per_cat[cat]
            if s.tp + s.fp + s.fn == 0:
                per_class[cat] = dict(pq=0.0, sq=0.0, rq=0.0, precision=0.0,
                                      recall=0.0, iou=0.0, tp=0, fp=0, fn=0)
                continue
            n += 1
            denom = s.tp + 0.5 * s.fp + 0.5 * s.fn
            per_class[cat] = dict(
                pq=s.iou / denom,
                sq=s.iou / s.tp if s.tp else 0.0,
                rq=s.tp / denom,
                precision=s.tp / (s.tp + s.fp) if s.tp + s.fp else 0.0,
                recall=s.tp / (s.tp + s.fn) if s.tp + s.fn else 0.0,
                iou=s.iou, tp=s.tp, fp=s.fp, fn=s.fn,
            )
            for key in ("pq", "sq", "rq", "precision", "recall"):
                sums[key] += per_class[cat][key]
        avg = {k: (sums[k] / n if n else 0.0)
               for k in ("pq", "sq", "rq", "precision", "recall")}
        avg["n"] = n
        return avg, per_class


def _segments_by_id(segments_info: Sequence[Mapping], id_map: np.ndarray) -> dict:
    """Index segments by id with areas recomputed from the id map."""
    segs = {}
    for el in segments_info:
        segs[el["id"]] = dict(el)
    ids, counts = np.unique(id_map, return_counts=True)
    for sid, cnt in zip(ids, counts):
        if sid == VOID:
            continue
        if sid not in segs:
            raise KeyError(f"segment id {sid} present in map but not in segments_info")
        segs[sid]["area"] = int(cnt)
    # drop segments with no pixels in this frame
    return {k: v for k, v in segs.items() if "area" in v and v["area"] > 0}


def vpq_single_video(
    gt_frames: Sequence[tuple[np.ndarray, Sequence[Mapping]]],
    pred_frames: Sequence[tuple[np.ndarray, Sequence[Mapping]]],
    nframes: int,
) -> PQStat:
    """Accumulate tube-matching stats over all nframes windows of one video.

    Each frame is (id_map (H, W) int, segments_info [{id, category_id,
    isthing?, iscrowd?}]).
    """
    stat = PQStat()
    t = len(gt_frames)
    for start in range(0, t - nframes + 1):
        gt_tube, pred_tube = [], []
        gt_segs: dict = {}
        pred_segs: dict = {}
        for i in range(start, start + nframes):
            gt_map, gt_info = gt_frames[i]
            pred_map, pred_info = pred_frames[i]
            gt_tube.append(gt_map.astype(np.int64))
            pred_tube.append(pred_map.astype(np.int64))
            for sid, seg in _segments_by_id(gt_info, gt_map).items():
                if sid in gt_segs:
                    gt_segs[sid]["area"] += seg["area"]
                else:
                    gt_segs[sid] = dict(seg)
            for sid, seg in _segments_by_id(pred_info, pred_map).items():
                if sid in pred_segs:
                    pred_segs[sid]["area"] += seg["area"]
                else:
                    pred_segs[sid] = dict(seg)

        gt_cat = np.stack(gt_tube)
        pred_cat = np.stack(pred_tube)
        combined = gt_cat * _OFFSET + pred_cat
        labels, counts = np.unique(combined, return_counts=True)
        intersections = {
            (int(l // _OFFSET), int(l % _OFFSET)): int(c)
            for l, c in zip(labels, counts)
        }

        gt_matched, pred_matched = set(), set()
        for (gt_id, pred_id), inter in intersections.items():
            if gt_id not in gt_segs or pred_id not in pred_segs:
                continue
            if gt_segs[gt_id].get("iscrowd", 0) == 1:
                continue
            if gt_segs[gt_id]["category_id"] != pred_segs[pred_id]["category_id"]:
                continue
            union = (
                pred_segs[pred_id]["area"] + gt_segs[gt_id]["area"] - inter
                - intersections.get((VOID, pred_id), 0)
            )
            iou = inter / union
            if iou > 0.5:
                cat = gt_segs[gt_id]["category_id"]
                stat[cat].tp += 1
                stat[cat].iou += iou
                gt_matched.add(gt_id)
                pred_matched.add(pred_id)

        crowd_by_cat: dict[int, int] = {}
        for gt_id, info in gt_segs.items():
            if gt_id in gt_matched:
                continue
            if info.get("iscrowd", 0) == 1:
                crowd_by_cat[info["category_id"]] = gt_id
                continue
            stat[info["category_id"]].fn += 1

        for pred_id, info in pred_segs.items():
            if pred_id in pred_matched:
                continue
            inter = intersections.get((VOID, pred_id), 0)
            if info["category_id"] in crowd_by_cat:
                inter += intersections.get(
                    (crowd_by_cat[info["category_id"]], pred_id), 0
                )
            if inter / info["area"] > 0.5:
                continue
            stat[info["category_id"]].fp += 1
    return stat


def vpq_compute(
    videos: Sequence[tuple[Sequence, Sequence]],
    categories: Mapping[int, Mapping],
    nframes: int,
    num_workers: int = 0,
) -> dict:
    """VPQ over a dataset. ``videos`` = [(gt_frames, pred_frames), ...].

    Returns {'all': ..., 'things': ..., 'stuff': ..., 'per_class': ...} with
    values in [0, 1].
    """
    stat = PQStat()
    if num_workers and len(videos) > 1:
        import multiprocessing as mp

        with mp.Pool(num_workers) as pool:
            parts = pool.starmap(
                vpq_single_video,
                [(gt, pred, nframes) for gt, pred in videos],
            )
        for p in parts:
            stat += p
    else:
        for gt, pred in videos:
            stat += vpq_single_video(gt, pred, nframes)

    out = {}
    out["all"], out["per_class"] = stat.average(categories, isthing=None)
    out["things"], _ = stat.average(categories, isthing=True)
    out["stuff"], _ = stat.average(categories, isthing=False)
    return out


def vpq_average_over_windows(
    videos, categories, window_sizes=(1, 2, 4, 8), num_workers: int = 0
) -> dict:
    """The headline metric: mean VPQ over window sizes (vps_eval.py:341-376
    evaluates {4, 8}; VSPW convention averages {1, 2, 4, 8})."""
    per_window = {
        k: vpq_compute(videos, categories, k, num_workers) for k in window_sizes
    }
    return {
        "vpq": float(np.mean([per_window[k]["all"]["pq"] for k in window_sizes])),
        "per_window": per_window,
    }
