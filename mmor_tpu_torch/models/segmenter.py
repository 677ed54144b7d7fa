"""Frame segmenter: ResNet-50 + MSDeformAttn pixel decoder + masked-attn decoder.

Counterpart of ``mmor_tpu/models/segmenter.py`` (the reference's per-frame
``MaskFormer`` segmenter inside MinVIS/DVIS). Frames of a clip are batched as
(B*T) through the backbone and pixel decoder; queries are per clip in the
video decoder.

The JAX config's ``sampler`` field ("gather" | "pallas" | "tiled") chooses
between three TPU implementations of the deformable attention core; the
port has one, K6, so its config has no such field. The backbone is
ResNet-50, the only one ported: the JAX config's ``backbone`` field (Swin,
ViT-Adapter) comes back with the slice that ports another.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from mmor_tpu_torch.models.mask2former_decoder import (
    MaskDecoderConfig,
    VideoMaskedTransformerDecoder,
)
from mmor_tpu_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
from mmor_tpu_torch.models.resnet import ResNet50

# ImageNet statistics used by detectron2's preprocessing
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


@dataclass(frozen=True)
class SegmenterConfig:
    decoder: MaskDecoderConfig = field(default_factory=MaskDecoderConfig)
    conv_dim: int = 256
    mask_dim: int = 256
    pixel_decoder_layers: int = 6
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def tiny(cls, **kw):
        base = dict(decoder=MaskDecoderConfig.tiny(), conv_dim=32, mask_dim=32,
                    pixel_decoder_layers=2)
        base.update(kw)
        return cls(**base)


def normalize_pixels(images: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8/float RGB -> detectron2-normalized f32."""
    mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(PIXEL_STD, dtype=torch.float32, device=images.device)
    return (images.float() - mean) / std


class VideoSegmenter(nn.Module):
    def __init__(self, cfg: SegmenterConfig):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.backbone = ResNet50(**kw)
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            conv_dim=cfg.conv_dim, mask_dim=cfg.mask_dim,
            n_layers=cfg.pixel_decoder_layers, **kw)
        self.decoder = VideoMaskedTransformerDecoder(cfg.decoder, in_channels=cfg.conv_dim)

    def forward(self, images: torch.Tensor, num_frames: int = 1) -> dict:
        """images: (B*T, H, W, 3) normalized pixels. Returns the decoder's
        outputs (pred_logits (B, Q, K+1), pred_masks (B, Q, T, H/4, W/4),
        pred_embds, aux_outputs) and mask_features (B, T, H/4, W/4, C)."""
        mask_features, multi_scale = self.pixel_decoder(self.backbone(images))
        bt, h4, w4, c = mask_features.shape
        mask_features = mask_features.reshape(bt // num_frames, num_frames, h4, w4, c)
        out = self.decoder(multi_scale, mask_features, num_frames)
        out["mask_features"] = mask_features
        return out
