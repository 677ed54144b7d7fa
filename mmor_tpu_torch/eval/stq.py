"""Segmentation and Tracking Quality (STQ) — association x semantic quality.

Copy of ``mmor_tpu/eval/stq.py``: the port imports nothing of the JAX
package, so it keeps its own copy of the host code it uses.

Equivalent of the reference's STQ tooling
(`utils/segmentation_and_tracking_quality.py`, the STEP/VSPW metric):

- AQ (association quality): for each GT track (tube over the whole video),
  sum over overlapping predicted tracks of ``|p∩g| * IoU(p, g)`` normalized
  by the track size, averaged over GT tracks;
- SQ (segmentation quality): class-wise IoU of the semantic maps, averaged
  over classes with support (mIoU);
- STQ = sqrt(AQ * SQ).

Inputs are per-frame (semantic_map, instance_map) pairs; VOID semantic id 255
(or a configured ignore label) is excluded.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Sequence

import numpy as np


def stq(
    gt_frames: Sequence[tuple[np.ndarray, np.ndarray]],
    pred_frames: Sequence[tuple[np.ndarray, np.ndarray]],
    num_classes: int,
    things_classes: Sequence[int] | None = None,
    ignore_label: int = 255,
) -> dict:
    """gt/pred_frames: [(semantic (H,W), instance (H,W)), ...] per frame."""
    assert len(gt_frames) == len(pred_frames)

    # ---------------- SQ: semantic mIoU over the whole video ----------- #
    inter = np.zeros(num_classes, np.int64)
    union = np.zeros(num_classes, np.int64)
    for (gt_sem, _), (pr_sem, _) in zip(gt_frames, pred_frames):
        valid = gt_sem != ignore_label
        for c in np.union1d(np.unique(gt_sem[valid]), np.unique(pr_sem[valid])):
            if c >= num_classes:
                continue
            g = (gt_sem == c) & valid
            p = (pr_sem == c) & valid
            inter[c] += np.logical_and(g, p).sum()
            union[c] += np.logical_or(g, p).sum()
    present = union > 0
    sq = float(np.mean(inter[present] / union[present])) if present.any() else 0.0

    # ---------------- AQ: track association quality -------------------- #
    # track key = (semantic class, instance id); tubes span all frames
    track_classes = set(things_classes) if things_classes is not None else None
    gt_sizes: dict = defaultdict(int)
    pred_sizes: dict = defaultdict(int)
    overlaps: dict = defaultdict(int)
    for (gt_sem, gt_inst), (pr_sem, pr_inst) in zip(gt_frames, pred_frames):
        valid = gt_sem != ignore_label
        # packing invariants (the reference validates its offset against
        # num_classes * max_instances_per_category the same way): instance
        # ids must fit in the 1e6 slot and packed keys in the 1e10 slot,
        # otherwise distinct tracks would silently collide.
        if gt_inst.size and int(max(gt_inst.max(), pr_inst.max())) >= 1_000_000:
            raise ValueError("instance ids must be < 1_000_000 for STQ packing")
        if num_classes * 1_000_000 >= 10_000_000_000:
            raise ValueError("num_classes too large for STQ pair packing")
        gt_key = gt_sem.astype(np.int64) * 1_000_000 + gt_inst.astype(np.int64)
        pr_key = pr_sem.astype(np.int64) * 1_000_000 + pr_inst.astype(np.int64)
        for k, c in zip(*np.unique(gt_key[valid], return_counts=True)):
            gt_sizes[int(k)] += int(c)
        for k, c in zip(*np.unique(pr_key[valid], return_counts=True)):
            pred_sizes[int(k)] += int(c)
        pair = gt_key[valid] * 10_000_000_000 + pr_key[valid]
        for k, c in zip(*np.unique(pair, return_counts=True)):
            overlaps[(int(k // 10_000_000_000), int(k % 10_000_000_000))] += int(c)

    aq_sum, n_tracks = 0.0, 0
    for g_key, g_size in gt_sizes.items():
        g_class = g_key // 1_000_000
        if track_classes is not None and g_class not in track_classes:
            continue
        n_tracks += 1
        acc = 0.0
        for (gk, pk), inter_px in overlaps.items():
            if gk != g_key:
                continue
            p_size = pred_sizes.get(pk, 0)
            iou = inter_px / max(g_size + p_size - inter_px, 1)
            acc += inter_px * iou
        aq_sum += acc / max(g_size, 1)
    aq = aq_sum / n_tracks if n_tracks else 0.0

    return {"stq": float(np.sqrt(aq * sq)), "aq": float(aq), "sq": sq}
