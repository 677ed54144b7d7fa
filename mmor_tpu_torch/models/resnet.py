"""ResNet-50 backbone (detectron2 geometry) for the panoptic segmenter.

Counterpart of ``mmor_tpu/models/resnet.py``: stem 7x7/2 with (3, 3) padding
+ 3x3/2 max-pool with (1, 1) padding, bottleneck stages [3, 4, 6, 3]
emitting res2 (1/4, 256) .. res5 (1/32, 2048), frozen BatchNorm as an affine
scale and bias. The stride-2 3x3 conv pads (1, 1) on both sides, as the
JAX module spells out (torch's symmetric padding; flax "SAME" would pad
(0, 1)). Convolutions are ``F.conv2d``: the JAX package leaves them to XLA,
outside any Pallas kernel.

Layout: the public input and outputs are NHWC, as in the JAX module; the
convolutions run on the same memory as NCHW tensors in channels-last order
(a permuted view, no copy).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmor_tpu_torch.models.common import Conv2d


class FrozenBN(nn.Module):
    """Affine-only normalization y = x * scale + bias (NCHW), the statistics of
    a trained BN folded into ``scale`` and ``bias``."""

    def __init__(self, features: int, *, dtype=torch.float32, param_dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(features, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)[:, None, None] + self.bias.to(x.dtype)[:, None, None]


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, bottleneck_channels: int,
                 stride: int = 1, *, dtype=torch.float32, param_dtype=torch.float32):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.has_shortcut = in_channels != out_channels or stride != 1
        if self.has_shortcut:
            self.shortcut_conv = Conv2d(in_channels, out_channels, 1, stride=stride,
                                        bias=False, **kw)
            self.shortcut_bn = FrozenBN(out_channels, **kw)
        self.conv1 = Conv2d(in_channels, bottleneck_channels, 1, bias=False, **kw)
        self.bn1 = FrozenBN(bottleneck_channels, **kw)
        self.conv2 = Conv2d(bottleneck_channels, bottleneck_channels, 3, stride=stride,
                            padding=1, bias=False, **kw)
        self.bn2 = FrozenBN(bottleneck_channels, **kw)
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1, bias=False, **kw)
        self.bn3 = FrozenBN(out_channels, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.shortcut_bn(self.shortcut_conv(x)) if self.has_shortcut else x
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + shortcut)


class ResNet50(nn.Module):
    """(N, H, W, 3) -> {'res2': 1/4 x 256, 'res3': 1/8 x 512,
    'res4': 1/16 x 1024, 'res5': 1/32 x 2048}, NHWC."""

    def __init__(self, *, dtype=torch.float32, param_dtype=torch.float32,
                 stage_blocks: tuple[int, ...] = (3, 4, 6, 3)):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.stem_conv = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, **kw)
        self.stem_bn = FrozenBN(64, **kw)
        self.stage_blocks = stage_blocks
        in_ch = 64
        for stage, (n_blocks, out_ch) in enumerate(zip(stage_blocks, (256, 512, 1024, 2048))):
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                setattr(self, f"res{stage + 2}_block{block}",
                        Bottleneck(in_ch, out_ch, out_ch // 4, stride, **kw))
                in_ch = out_ch

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC memory as channels-last NCHW
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outputs = {}
        for stage, n_blocks in enumerate(self.stage_blocks):
            for block in range(n_blocks):
                x = getattr(self, f"res{stage + 2}_block{block}")(x)
            outputs[f"res{stage + 2}"] = x.permute(0, 2, 3, 1)
        return outputs
