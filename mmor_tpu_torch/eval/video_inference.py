"""Host-side video inference: windowing, query matching, VPS maps.

Copy of ``mmor_tpu/eval/video_inference.py``: the port imports nothing of
the JAX package, so it keeps its own copy of the host code it uses.

Equivalents of the reference's eval-time logic:
- ``MinVIS.post_processing`` frame-by-frame cosine-Hungarian query alignment
  + logit averaging (`meta_architecture.py:258-305`);
- ``run_window_inference`` (`meta_architecture.py:306-330`, offline
  `:779-840`) — here a pure fold over jitted window steps with tracker state;
- ``inference_video_vps`` panoptic id-map construction
  (`meta_architecture.py:893-977`).

These run in numpy on host: outputs are variable-length (segments, ids) and
feed PNG/JSON dumps, not the training hot path.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def match_from_embds(tgt_embds: np.ndarray, cur_embds: np.ndarray) -> np.ndarray:
    """Permutation aligning current-frame queries to target queries."""
    cur = cur_embds / (np.linalg.norm(cur_embds, axis=1, keepdims=True) + 1e-12)
    tgt = tgt_embds / (np.linalg.norm(tgt_embds, axis=1, keepdims=True) + 1e-12)
    cost = 1 - cur @ tgt.T
    indices = linear_sum_assignment(cost.T)
    return indices[1]


def minvis_post_process(
    pred_logits: np.ndarray,  # (T, Q, K+1) per-frame logits
    pred_masks: np.ndarray,  # (T, Q, H, W)
    pred_embds: np.ndarray,  # (T, Q, C)
) -> tuple[np.ndarray, np.ndarray]:
    """Frame-by-frame query alignment; returns (avg_logits (Q, K+1),
    aligned_masks (Q, T, H, W))."""
    t = pred_logits.shape[0]
    out_logits = [pred_logits[0]]
    out_masks = [pred_masks[0]]
    out_embds = [pred_embds[0]]
    for i in range(1, t):
        indices = match_from_embds(out_embds[-1], pred_embds[i])
        out_logits.append(pred_logits[i][indices])
        out_masks.append(pred_masks[i][indices])
        out_embds.append(pred_embds[i][indices])
    avg_logits = np.mean(out_logits, axis=0)
    masks = np.stack(out_masks, axis=1)
    return avg_logits, masks


def run_window_inference(window_step, frames: np.ndarray, window_size: int):
    """Fold ``window_step(frames_window, state) -> (outputs, state)`` over a
    full video. ``frames``: (T, H, W, 3). Short final windows are padded to
    ``window_size`` (static shapes for the jitted step) and the padding is
    dropped from the outputs. ``window_step`` must return dict values with
    the frame axis FIRST.

    Returns a dict of np arrays concatenated on the frame axis.
    """
    t = len(frames)
    state = None
    chunks: list[dict[str, np.ndarray]] = []
    for start in range(0, t, window_size):
        window = frames[start : start + window_size]
        n_real = len(window)
        if n_real < window_size:
            pad = np.repeat(window[-1:], window_size - n_real, axis=0)
            window = np.concatenate([window, pad], axis=0)
        outputs, state = window_step(window, state)
        chunks.append({k: np.asarray(v)[:n_real] for k, v in outputs.items()})
    return {k: np.concatenate([c[k] for c in chunks], axis=0) for k in chunks[0]}


def vps_inference(
    pred_cls: np.ndarray,  # (Q, K+1) video-level logits
    pred_masks: np.ndarray,  # (Q, T, H, W) mask logits (output resolution)
    pred_ids: np.ndarray,  # (Q,) query/track ids
    num_classes: int,
    num_thing_classes: int,
    object_mask_threshold: float = 0.8,
    overlap_threshold: float = 0.8,
) -> dict:
    """Panoptic id map per frame + segment infos (meta_architecture.py:893-977)."""
    probs = _softmax(pred_cls)
    scores = probs.max(-1)
    labels = probs.argmax(-1)

    keep = (labels != num_classes) & (scores > object_mask_threshold)
    cur_scores = scores[keep]
    cur_classes = labels[keep]
    cur_ids = pred_ids[keep]
    cur_masks = _sigmoid(pred_masks[keep])  # (Nk, T, H, W)

    t, h, w = pred_masks.shape[1:]
    panoptic_seg = np.zeros((t, h, w), dtype=np.int32)
    segments_infos: list[dict] = []
    out_ids: list = []
    current_segment_id = 0

    if cur_masks.shape[0] == 0:
        return {"pred_masks": panoptic_seg, "segments_infos": segments_infos,
                "pred_ids": out_ids, "task": "vps"}

    prob_masks = cur_scores[:, None, None, None] * cur_masks
    mask_ids = prob_masks.argmax(0)  # (T, H, W)
    stuff_memory: dict[int, int] = {}
    for k in range(cur_classes.shape[0]):
        pred_class = int(cur_classes[k])
        isthing = pred_class < num_thing_classes
        mask_area = int((mask_ids == k).sum())
        original_area = int((cur_masks[k] >= 0.5).sum())
        mask = (mask_ids == k) & (cur_masks[k] >= 0.5)
        if mask_area > 0 and original_area > 0 and mask.sum() > 0:
            if mask_area / original_area < overlap_threshold:
                continue
            if not isthing:
                if pred_class in stuff_memory:
                    panoptic_seg[mask] = stuff_memory[pred_class]
                    continue
                stuff_memory[pred_class] = current_segment_id + 1
            current_segment_id += 1
            panoptic_seg[mask] = current_segment_id
            segments_infos.append({
                "id": current_segment_id,
                "isthing": bool(isthing),
                "category_id": pred_class,
            })
            out_ids.append(cur_ids[k])

    return {"pred_masks": panoptic_seg, "segments_infos": segments_infos,
            "pred_ids": out_ids, "task": "vps"}


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))
