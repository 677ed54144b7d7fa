"""Typed configuration for the MM2SG stack, with torch dtypes.

Counterpart of ``mmor_tpu/config.py`` (which imports jax for its dtypes):
the same frozen dataclasses, field names and ``tiny()`` presets, plus the
``tiny``/``small``/``7b`` presets of ``__graft_entry__._preset`` and a torch
twin of its ``_example_batch``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from mmor_tpu_torch.sg.prompts import IMAGE_TOKEN_INDEX


@dataclass(frozen=True)
class LlamaConfig:
    """Llama-family decoder (the MM2SG language model, LLaVA-v1.5-7B base).

    Serving configurations the port implements: per-op decode with int8 or
    int4 weights (``weight_bits`` 8 or 4, the latter with per-(K-group,
    channel) scales, ``weight_group`` rows a group) and an int8 KV cache;
    and the decode megakernel (``mega_decode``) with int8 or int4 weights
    and an int8 or int4 KV cache (``kv_bits``), each pair of widths."""

    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    rope_theta: float = 10000.0
    max_seq_len: int = 4096
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    weight_quant: bool = False  # packed int8 weights (K2)
    quant_int8_mxu: bool = True  # W8A8 (int8 activations) vs W8A16
    weight_bits: int = 8
    weight_group: int = 1024
    kv_bits: int = 8
    ffn_pad: int = 0  # zero ffn channels appended at quantization (exact)
    fused_qkv: bool = False  # fused qkv_proj / gate_up_proj weights
    kv_quant: bool = False  # int8 KV cache (K4 decode)
    mega_decode: bool = False
    tp_segments: int = 1

    def __post_init__(self):
        if self.weight_bits not in (4, 8) or self.kv_bits not in (4, 8):
            raise ValueError(f"weight_bits {self.weight_bits} / kv_bits "
                             f"{self.kv_bits}: each must be 4 or 8")
        if self.kv_bits == 4 and not self.mega_decode:
            raise ValueError("an int4 KV cache is served only by the decode "
                             "megakernel (mega_decode=True)")
        if self.tp_segments != 1:
            raise NotImplementedError("tensor-parallel layouts come with slice 12")

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def llava_7b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        base = dict(
            vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=4,
            ffn_dim=128, max_seq_len=128, dtype=torch.float32,
            param_dtype=torch.float32,
        )
        base.update(kw)
        return cls(**base)


def pick_ck(cfg: LlamaConfig) -> int:
    """The decode megakernel's K-chunk width for ``cfg``, which is also the
    int4 scale group the weights are quantized with
    (``mmor_tpu/ops/mega_decode.py::MegaGeometry.pick_ck``): the widest of
    1024, 512, ..., 16 that holds whole heads, divides the model and padded
    ffn widths and the head count in heads per chunk, and tiles the q width
    in pairs."""
    dh = cfg.head_dim
    ffn = cfg.ffn_dim + cfg.ffn_pad
    qw = cfg.n_heads * dh
    for cand in (1024, 512, 256, 128, 64, 32, 16):
        if (cand % dh == 0 and cfg.dim % cand == 0 and ffn % cand == 0
                and cfg.n_heads % max(1, cand // dh) == 0
                and qw % (2 * cand) == 0):
            return cand
    raise ValueError(f"no legal K-chunk for dim={cfg.dim} ffn={ffn} dh={dh}")


@dataclass(frozen=True)
class ClipVitConfig:
    """CLIP ViT vision tower (openai/clip-vit-large-patch14-336 geometry)."""

    image_size: int = 336
    patch_size: int = 14
    dim: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    mlp_dim: int = 4096
    feature_layer_offset: int = -2  # hidden_states[-2]: run n_layers-1 blocks
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16

    @property
    def tokens_per_image(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def tiny(cls, **kw) -> "ClipVitConfig":
        base = dict(
            image_size=28, patch_size=14, dim=32, n_layers=3, n_heads=2,
            mlp_dim=64, dtype=torch.float32, param_dtype=torch.float32,
        )
        base.update(kw)
        return cls(**base)


@dataclass(frozen=True)
class PoolerConfig:
    """Multi-view fusion pooler (BERT-style encoder over the view tokens)."""

    hidden: int = 1024
    n_layers: int = 2
    n_heads: int = 8
    mlp_dim: int = 4096
    max_views: int = 7
    tokens_per_view: int = 576
    out_tokens: int = 576
    pc_feature_dim: int = 512
    audio_dim: int = 512
    num_segmask_tokens: int = 3
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16

    @property
    def max_positions(self) -> int:
        return self.tokens_per_view * self.max_views

    @classmethod
    def tiny(cls, **kw) -> "PoolerConfig":
        base = dict(
            hidden=32, n_layers=2, n_heads=2, mlp_dim=64, max_views=3,
            tokens_per_view=4, out_tokens=4, pc_feature_dim=16, audio_dim=16,
            dtype=torch.float32, param_dtype=torch.float32,
        )
        base.update(kw)
        return cls(**base)


@dataclass(frozen=True)
class SegmaskEncoderConfig:
    """32x32 label-map CNN encoder."""

    num_classes: int = 30
    embed_dim: int = 8
    out_dim: int = 1024
    mask_size: int = 32
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls, **kw) -> "SegmaskEncoderConfig":
        base = dict(out_dim=32, dtype=torch.float32, param_dtype=torch.float32)
        base.update(kw)
        return cls(**base)


@dataclass(frozen=True)
class PTv3Config:
    """PointTransformerV3 (cls_mode) point-cloud encoder."""

    in_channels: int = 6
    enc_channels: tuple[int, ...] = (32, 64, 128, 256, 512)
    enc_depths: tuple[int, ...] = (2, 2, 2, 6, 2)
    enc_heads: tuple[int, ...] = (2, 4, 8, 16, 32)
    patch_size: int = 1024
    grid_size: float = 0.01
    max_points: int = 65536
    mlp_ratio: float = 4.0
    out_dim: int = 512
    orders: tuple[str, ...] = ("z", "z-trans", "hilbert", "hilbert-trans")
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def tiny(cls, **kw) -> "PTv3Config":
        base = dict(
            enc_channels=(8, 16), enc_depths=(1, 1), enc_heads=(2, 2),
            patch_size=16, max_points=256, out_dim=16,
            dtype=torch.float32, param_dtype=torch.float32,
        )
        base.update(kw)
        return cls(**base)


@dataclass(frozen=True)
class MM2SGConfig:
    """Full multimodal scene-graph generator: towers + pooler + projector + LM."""

    llama: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    vision: ClipVitConfig = dataclasses.field(default_factory=ClipVitConfig)
    pooler: PoolerConfig = dataclasses.field(default_factory=PoolerConfig)
    segmask: SegmaskEncoderConfig = dataclasses.field(default_factory=SegmaskEncoderConfig)
    ptv3: PTv3Config = dataclasses.field(default_factory=PTv3Config)
    max_prompt_len: int = 2048
    max_new_tokens: int = 300

    @property
    def num_multimodal_tokens(self) -> int:
        # fused image tokens + 1 pc + 1 audio + segmask tokens
        return self.pooler.out_tokens + 2 + self.pooler.num_segmask_tokens

    @classmethod
    def tiny(cls, **kw) -> "MM2SGConfig":
        base = dict(
            llama=LlamaConfig.tiny(),
            vision=ClipVitConfig.tiny(),
            pooler=PoolerConfig.tiny(hidden=32),
            segmask=SegmaskEncoderConfig.tiny(),
            ptv3=PTv3Config.tiny(),
            max_prompt_len=64,
            max_new_tokens=8,
        )
        base.update(kw)
        return cls(**base)


def preset(name: str) -> MM2SGConfig:
    """``tiny`` | ``small`` | ``7b``, as ``__graft_entry__._preset``."""
    if name == "tiny":
        return MM2SGConfig.tiny()
    if name == "7b":
        return MM2SGConfig()
    if name != "small":
        raise ValueError(f"unknown preset {name!r}")
    return MM2SGConfig(
        llama=LlamaConfig(vocab_size=32000, dim=1024, n_layers=4, n_heads=8,
                          n_kv_heads=8, ffn_dim=2816, max_seq_len=2048),
        vision=ClipVitConfig(image_size=336, patch_size=14, dim=256, n_layers=4,
                             n_heads=8, mlp_dim=1024),
        pooler=PoolerConfig(hidden=256, n_layers=2, n_heads=8, mlp_dim=1024,
                            max_views=7, tokens_per_view=576, out_tokens=576,
                            pc_feature_dim=512, audio_dim=512),
        segmask=SegmaskEncoderConfig(out_dim=256),
        max_prompt_len=512,
        max_new_tokens=32,
    )


# native camera resolutions: MM-OR azure RGB frames, then the 16:9 robot
# screen / trackercam slots
AZURE_SIZE, SCREEN_SIZE = (1536, 2048), (1080, 1920)


def require_device(device: torch.device | str) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU: a CUDA device with no card present raises here, at entry,
    rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mmor_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' (--device cpu) to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return device


def example_batch(cfg: MM2SGConfig, batch: int, prompt_len: int, seed: int,
                  device: torch.device | str = "cuda",
                  raw_views: bool = False) -> dict[str, torch.Tensor]:
    """Seeded synthetic batch (``__graft_entry__._example_batch``'s twin).

    With ``raw_views`` the images are a tuple of per-slot uint8 frames at
    their native camera sizes (up to five azure slots, then screens); otherwise
    preprocessed (B, V, S, S, 3) pixels in the vision tower's dtype."""
    device = require_device(device)
    gen = torch.Generator().manual_seed(seed)
    v = cfg.pooler.max_views
    size = cfg.vision.image_size
    ids = torch.randint(3, cfg.llama.vocab_size, (batch, prompt_len), generator=gen,
                        dtype=torch.int32)
    ids[:, 4] = IMAGE_TOKEN_INDEX
    out = {
        "input_ids": ids,
        "attention_mask": torch.ones(batch, prompt_len, dtype=torch.int32),
        "view_mask": torch.ones(batch, v, dtype=torch.int32),
        "pc_feature": torch.randn(batch, cfg.pooler.pc_feature_dim, generator=gen),
        "audio_embedding": torch.randn(batch, cfg.pooler.audio_dim, generator=gen),
        "segmasks": torch.zeros(batch, cfg.pooler.num_segmask_tokens, 32, 32,
                                dtype=torch.int32),
    }
    if raw_views:
        # frames are made on the device: 8 x 7 native frames are ~0.5 GB
        dev_gen = torch.Generator(device=device).manual_seed(seed)
        sizes = [AZURE_SIZE] * min(5, v) + [SCREEN_SIZE] * max(0, v - 5)
        out["raw_views"] = tuple(
            torch.randint(0, 256, (batch, h, w, 3), generator=dev_gen,
                          dtype=torch.uint8, device=device)
            for h, w in sizes)
    else:
        out["images"] = torch.randn(batch, v, size, size, 3,
                                    generator=gen).to(cfg.vision.dtype)
    return {k: (val.to(device) if isinstance(val, torch.Tensor) else val)
            for k, val in out.items()}
