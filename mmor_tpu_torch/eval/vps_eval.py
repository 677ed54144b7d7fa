"""VPS evaluator: collect per-video panoptic predictions, dump artifacts,
compute VPQ (+STQ).

Copy of ``mmor_tpu/eval/vps_eval.py``: the port imports nothing of the JAX
package, so it keeps its own copy of the host code it uses.

Equivalent of the reference ``VPSEvaluator``
(`dvis_Plus/data_video/vps_eval.py:101-376`): per frame it writes the
panoptic id map as a color PNG (panopticapi codec) plus a JSON record of
segments; ``evaluate`` aggregates all videos and computes VPQ at window sizes
{4, 8} (plus 1, 2 for the VSPW-style average) and per-class PQ. Rank
gathering is unnecessary here — the window-inference loop is already a
single host process feeding the device path.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
from PIL import Image

from mmor_tpu_torch.data.panoptic import categories, id2rgb
from mmor_tpu_torch.eval.stq import stq
from mmor_tpu_torch.eval.vpq import vpq_average_over_windows


@dataclass
class VPSEvaluator:
    output_dir: Path | None = None
    window_sizes: tuple[int, ...] = (4, 8)  # vps_eval.py:344
    _videos: dict = field(default_factory=dict)

    def process(
        self,
        video_id: str,
        pred_masks: np.ndarray,  # (T, H, W) panoptic id maps
        segments_infos: list[dict],  # video-level segment infos
        gt_masks: np.ndarray,  # (T, H, W)
        gt_segments_infos: list[list[dict]],  # per frame
    ) -> None:
        """Register one video's predictions + ground truth."""
        per_frame_pred = []
        for t in range(pred_masks.shape[0]):
            frame_ids = set(np.unique(pred_masks[t])) - {0}
            infos = [s for s in segments_infos if s["id"] in frame_ids]
            per_frame_pred.append((pred_masks[t], infos))
        per_frame_gt = [
            (gt_masks[t], gt_segments_infos[t]) for t in range(gt_masks.shape[0])
        ]
        self._videos[video_id] = (per_frame_gt, per_frame_pred)

        if self.output_dir is not None:
            out = Path(self.output_dir) / "pan_pred" / video_id
            out.mkdir(parents=True, exist_ok=True)
            annotations = []
            for t in range(pred_masks.shape[0]):
                Image.fromarray(id2rgb(pred_masks[t])).save(out / f"{t:06d}.png")
                annotations.append({
                    "frame": t,
                    "segments_info": per_frame_pred[t][1],
                })
            (out / "pred.json").write_text(json.dumps(annotations))

    def evaluate(self, num_workers: int = 0) -> dict:
        cats = categories()
        videos = list(self._videos.values())
        result = vpq_average_over_windows(
            videos, cats, window_sizes=self.window_sizes, num_workers=num_workers
        )

        # STQ over the same videos: semantic = category (panoptic id // 10),
        # instance = panoptic id
        stq_scores = []
        for gt_frames, pred_frames in videos:
            gt = [(m // 10, m) for m, _ in gt_frames]
            pr = [(m // 10, m) for m, _ in pred_frames]
            stq_scores.append(stq(gt, pr, num_classes=len(cats)))
        result["stq"] = float(np.mean([s["stq"] for s in stq_scores])) if stq_scores else 0.0
        result["aq"] = float(np.mean([s["aq"] for s in stq_scores])) if stq_scores else 0.0
        result["sq"] = float(np.mean([s["sq"] for s in stq_scores])) if stq_scores else 0.0
        return result
