"""Video panoptic meta-architecture: DVIS++ online (and MinVIS through it).

Counterpart of ``mmor_tpu/models/meta_arch.py`` (the reference's
``DVIS_Plus_online``, `dvis_Plus/meta_architecture.py`): a frame segmenter
and a referring tracker whose state resumes across windows. MinVIS is the
segmenter alone, its identities recovered on the host
(``eval/video_inference.py``). The offline temporal refiner is not ported
yet, so ``DVISConfig`` has no ``refiner`` field.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from mmor_tpu_torch.models.common import init_params
from mmor_tpu_torch.models.layers import DeformableAttention
from mmor_tpu_torch.models.segmenter import SegmenterConfig, VideoSegmenter
from mmor_tpu_torch.models.tracker import ReferringTracker, TrackerConfig, TrackerState


@dataclass(frozen=True)
class DVISConfig:
    segmenter: SegmenterConfig = field(default_factory=SegmenterConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    window_size: int = 3  # test-time window (Base yaml TEST.WINDOW_SIZE)
    object_mask_threshold: float = 0.8
    overlap_threshold: float = 0.8

    @classmethod
    def tiny(cls, **kw):
        base = dict(segmenter=SegmenterConfig.tiny(), tracker=TrackerConfig.tiny())
        base.update(kw)
        return cls(**base)


class DVISPlus(nn.Module):
    def __init__(self, cfg: DVISConfig):
        super().__init__()
        self.cfg = cfg
        self.segmenter = VideoSegmenter(cfg.segmenter)
        self.tracker = ReferringTracker(cfg.tracker)

    def segment_frames(self, images: torch.Tensor) -> dict:
        """Frame-independent segmentation, every frame its own queries:
        images (B*T, H, W, 3) -> pred_embds (B*T, Q, C), pred_masks
        (B*T, Q, 1, H/4, W/4), pred_logits (B*T, Q, K+1), mask_features."""
        return self.segmenter(images, 1)

    def track(self, frame_embeds: torch.Tensor, frame_embeds_no_norm: torch.Tensor,
              mask_features: torch.Tensor, state: TrackerState | None = None):
        return self.tracker(frame_embeds, frame_embeds_no_norm, mask_features, state=state)


def init_random(model: nn.Module, seed: int = 0) -> None:
    """Seeded random weights in place: N(0, 0.02), norm scales 1, biases 0,
    and the deformable attention's directional offset-bias grid (so each
    head samples up to n_points pixels along its own direction, as the
    reference's init does)."""
    device = next(model.parameters()).device
    init_params(model, torch.Generator(device=device).manual_seed(seed))
    for module in model.modules():
        if isinstance(module, DeformableAttention):
            module.reset_offsets()
