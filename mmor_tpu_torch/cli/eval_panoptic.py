"""Panoptic evaluation CLI on the PyTorch port (``mmor_tpu.cli.eval_panoptic``'s twin).

Runs windowed DVIS++ online inference over video records (the tracker state
folded across windows), builds per-frame panoptic maps and computes VPQ@{4,8}
and STQ with the VPS evaluator.

Usage:
  python -m mmor_tpu_torch.cli.eval_panoptic --synthetic [--arch dvis|minvis]
      [--tiny] [--device cuda]
  python -m mmor_tpu_torch.cli.eval_panoptic --data_root MM-OR_data [--split test]

The weights are random from a fixed seed: trained DVIS++ weights need the
orbax-to-torch checkpoint converter, which is not ported yet, so
``--checkpoint`` raises. The run needs a CUDA device unless ``--device cpu``
asks for the plain PyTorch version of the deformable attention kernel (K6).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from mmor_tpu_torch.config import require_device
from mmor_tpu_torch.data.panoptic import LABEL_DIVISOR, categories
from mmor_tpu_torch.eval.video_inference import (
    minvis_post_process,
    run_window_inference,
    vps_inference,
)
from mmor_tpu_torch.eval.vps_eval import VPSEvaluator
from mmor_tpu_torch.models.meta_arch import DVISConfig, DVISPlus, init_random
from mmor_tpu_torch.models.segmenter import normalize_pixels


def make_window_step(model: DVISPlus, window_size: int, arch: str = "dvis"):
    """(frames (T, H, W, 3) numpy, tracker state) -> (frame-first numpy
    outputs, new state), on the model's device.

    ``arch='dvis'`` runs the referring tracker (window-resumed state);
    ``arch='minvis'`` returns the per-frame segmenter outputs for post-hoc
    cosine-Hungarian alignment."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def step(frames: torch.Tensor, state):
        seg = model.segment_frames(normalize_pixels(frames))
        q, c = seg["pred_embds"].shape[1:]
        if arch == "minvis":
            return {"pred_logits": seg["pred_logits"],  # (T, Q, K+1)
                    "pred_masks": seg["pred_masks"][:, :, 0],  # (T, Q, H, W)
                    "pred_embds": seg["pred_embds"]}, state  # (T, Q, C)
        embds = seg["pred_embds"].reshape(1, window_size, q, c)
        norm = embds / (torch.linalg.vector_norm(embds, dim=-1, keepdim=True) + 1e-6)
        mf = seg["mask_features"]
        mask_features = mf.reshape(1, window_size, *mf.shape[2:])
        out, new_state = model.track(norm, embds, mask_features, state=state)
        return {"pred_logits": out["pred_logits"][0],  # (T, Q, K+1)
                "pred_masks": out["pred_masks"][0].transpose(0, 1)}, new_state  # (T, Q, H, W)

    def wrapper(frames: np.ndarray, state):
        outputs, new_state = step(torch.from_numpy(np.asarray(frames)).to(device), state)
        return {k: v.float().cpu().numpy() for k, v in outputs.items()}, new_state

    return wrapper


def evaluate_videos(model: DVISPlus, video_iter, cfg: DVISConfig, output_dir=None,
                    num_workers: int = 0, arch: str = "dvis") -> dict:
    from PIL import Image

    evaluator = VPSEvaluator(output_dir=output_dir)
    num_classes = cfg.segmenter.decoder.num_classes
    n_things = len(categories())  # all OR classes tracked as things
    window_step = make_window_step(model, cfg.window_size, arch=arch)
    device = next(model.parameters()).device

    for record in video_iter:
        frames = np.stack([np.asarray(Image.open(f).convert("RGB"), dtype=np.float32)
                           for f in record["file_names"]])
        out = run_window_inference(window_step, frames, cfg.window_size)
        if arch == "minvis":
            video_logits, pred_masks = minvis_post_process(
                out["pred_logits"], out["pred_masks"], out["pred_embds"])
        else:
            # the tracker keeps query ids aligned, so a plain mean is the analogue
            video_logits = out["pred_logits"].mean(axis=0)  # (Q, K+1)
            pred_masks = out["pred_masks"].transpose(1, 0, 2, 3)  # (Q, T, H, W)
        gt = record["pan_seg"]
        if pred_masks.shape[-2:] != gt.shape[-2:]:  # upsample to GT resolution
            pred_masks = F.interpolate(torch.from_numpy(pred_masks).to(device),
                                       size=gt.shape[-2:], mode="bilinear",
                                       align_corners=False).cpu().numpy()
        result = vps_inference(
            video_logits, pred_masks, np.arange(video_logits.shape[0]),
            num_classes=num_classes, num_thing_classes=n_things,
            object_mask_threshold=cfg.object_mask_threshold,
            overlap_threshold=cfg.overlap_threshold)
        # panoptic ids in VPQ must carry the category: re-encode as cat*divisor
        remap = np.zeros((len(result["segments_infos"]) + 1,), np.int64)
        infos = []
        for s in result["segments_infos"]:
            remap[s["id"]] = s["category_id"] * LABEL_DIVISOR
            infos.append({"id": s["category_id"] * LABEL_DIVISOR,
                          "category_id": s["category_id"], "iscrowd": 0})
        pan = remap[result["pred_masks"]]
        infos = list({i["id"]: i for i in infos}.values())  # stuff merge
        evaluator.process(record["video_id"], pan, infos, gt, record["segments_infos"])
    return evaluator.evaluate(num_workers=num_workers)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", default=None,
                   help="the MM-OR panoptic tree; required unless --synthetic")
    p.add_argument("--split", default="test")
    p.add_argument("--checkpoint", default=None,
                   help="not supported yet: needs the orbax-to-torch converter")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--arch", choices=["dvis", "minvis"], default="dvis")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) or 'cpu', "
                        "which runs K6's plain PyTorch version")
    args = p.parse_args(argv)
    if not args.synthetic and args.data_root is None:
        p.error("--data_root is required without --synthetic")
    if args.checkpoint:
        raise NotImplementedError(
            "--checkpoint needs the orbax-to-torch converter for DVIS++ weights, "
            "which is not ported yet; run without it (seeded random weights)")
    cfg = DVISConfig.tiny() if args.tiny else DVISConfig()
    with torch.device(require_device(args.device)):
        model = DVISPlus(cfg)
    init_random(model, seed=0)
    model.eval()
    h = w = 64 if args.tiny else 512

    if args.synthetic:
        videos = _synthetic_videos(h, w)
    else:
        from mmor_tpu_torch.data.panoptic import MMORPanopticDataset

        videos = MMORPanopticDataset(args.data_root, split=args.split).video_records()

    result = evaluate_videos(model, videos, cfg, output_dir=args.output_dir, arch=args.arch)
    summary = {"vpq": result["vpq"], "stq": result["stq"],
               "vpq_per_window": {str(k): v["all"]["pq"]
                                  for k, v in result["per_window"].items()}}
    if args.output_dir:
        from mmor_tpu_torch.utils.logging import MetricsLogger

        logger = MetricsLogger(args.output_dir, echo=False)
        per_class = result["per_window"][max(result["per_window"])]["per_class"]
        record = {f"pq_class_{c}": m["pq"] for c, m in per_class.items()}
        record.update({f"vpq_w{k}": v for k, v in summary["vpq_per_window"].items()})
        logger.log(0, vpq=result["vpq"], stq=result["stq"], **record)
    print(json.dumps(summary, indent=2))
    return summary


def _synthetic_videos(h: int, w: int):
    """The JAX CLI's synthetic video: 4 seeded noise frames, class 5 on the
    left eighth of the 1/4-scale ground truth."""
    import tempfile

    from PIL import Image

    tmp = Path(tempfile.mkdtemp(prefix="mmor_panoptic_"))
    rng = np.random.default_rng(0)
    for t in range(4):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(tmp / f"{t}.jpg")
    gt = np.zeros((4, h // 4, w // 4), np.int64)
    gt[:, :, : w // 8] = 5 * LABEL_DIVISOR
    infos = [[{"id": 5 * LABEL_DIVISOR, "category_id": 5, "iscrowd": 0}]] * 4
    yield {"video_id": "synthetic_0", "file_names": [str(tmp / f"{t}.jpg") for t in range(4)],
           "pan_seg": gt, "segments_infos": infos}


if __name__ == "__main__":
    main()
