"""MM2SG training data pipeline: conversation JSON -> static-shape batches.

Copy of ``mmor_tpu/data/sg_train_data.py``: the port imports nothing of the JAX
package, so it keeps its own copy of the host code it uses.

Equivalent of the reference ``LazySupervisedDataset`` + collator + modality
sampler (`LLaVA/llava/train/train.py:767-1038`, `llava_trainer.py:39-131`):

- image-order augmentation: shuffle views, keep a random 1..max_views subset
  (`train.py:817-845`; synthetic-view constraints apply only to the synthetic
  hybrid data, handled by the same hook);
- multimodal dropout: with prob ``multimodal_drop_prop`` each, delete the
  robot/tracker/transcript text spans and drop the pc/audio/segmask tensors
  (`train.py:902-980`);
- targets supervise only the assistant turn (preprocess_v1 masking);
- batches group by modality signature and length (LengthGroupedSampler
  by-modality variant) and are padded to static buckets (a prompt bucket of
  512 tokens, doubled until the longest row fits), so batches take few shapes.
"""

from __future__ import annotations

import random
import re
from dataclasses import dataclass, field

import numpy as np

from mmor_tpu_torch.config import MM2SGConfig
from mmor_tpu_torch.data import preprocessing as pp
from mmor_tpu_torch.sg.prompts import (
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    VicunaConversation,
    left_pad_batch,
    tokenize_with_image_token,
)

_SPAN_RE = {
    "robot_metadata": re.compile(r"<robot_metadata_start>.*?<robot_metadata_end>\. ", re.S),
    "tracker_metadata": re.compile(r"<tracker_metadata_start>.*?<tracker_metadata_end>\. ", re.S),
    "speech_transcript": re.compile(r"<speech_transcript_start>.*?<speech_transcript_end>\. ", re.S),
}


@dataclass
class SGTrainDataConfig:
    do_img_order_augment: bool = True
    do_multimodal_augment: bool = True
    do_photometric_augment: bool = False  # TrivialAugment-style (train.py:693)
    multimodal_drop_prop: float = 0.5
    prompt_bucket: int = 512


def drop_metadata_span(text: str, kind: str) -> str:
    return _SPAN_RE[kind].sub("", text, count=1)


@dataclass
class SGTrainDataset:
    """Indexable dataset over generated conversation samples."""

    samples: list[dict]
    tokenizer: object
    model_cfg: MM2SGConfig
    cfg: SGTrainDataConfig = field(default_factory=SGTrainDataConfig)
    rng: random.Random = field(default_factory=random.Random)

    def __len__(self) -> int:
        return len(self.samples)

    def modality_signature(self, i: int) -> tuple:
        s = self.samples[i]
        return ("image" in s, "pc" in s, "audio" in s, "segmasks" in s)

    def sample_length(self, i: int) -> int:
        return len(self.samples[i]["conversations"][0]["value"])

    def __getitem__(self, i: int) -> dict:
        cfg, mcfg = self.cfg, self.model_cfg
        s = self.samples[i]
        human = s["conversations"][0]["value"]
        answer = s["conversations"][1]["value"]

        drop = (
            lambda: cfg.do_multimodal_augment
            and self.rng.random() < cfg.multimodal_drop_prop
        )
        for kind in _SPAN_RE:
            if drop():
                human = drop_metadata_span(human, kind)

        # image loading + order augmentation
        size = mcfg.vision.image_size
        v = mcfg.pooler.max_views
        image_files = list(s.get("image", []))
        if image_files and cfg.do_img_order_augment:
            self.rng.shuffle(image_files)
            n = self.rng.randint(1, min(v, len(image_files)))
            image_files = image_files[:n]
        image_files = image_files[:v]
        slots, mask = [], np.zeros((v,), np.int32)
        from PIL import Image

        for k, f in enumerate(image_files):
            try:
                img = Image.open(f).convert("RGB")
                if cfg.do_photometric_augment:
                    img = photometric_augment(img, self.rng)
                slots.append(pp.clip_preprocess(img, size))
            except OSError:
                slots.append(pp.black_image(size))
            mask[k] = 1
        while len(slots) < v:
            slots.append(np.zeros((size, size, 3), np.float32))

        # tokenization: full conversation + prompt-only prefix for masking
        conv = VicunaConversation()
        conv.append(conv.roles[0], human)
        conv.append(conv.roles[1], None)
        prompt = conv.prompt()
        prompt_ids = tokenize_with_image_token(prompt, self.tokenizer)
        answer_ids = [
            t for t in self.tokenizer.encode(answer)
            if t != getattr(self.tokenizer, "bos_token_id", None)
        ] + [self.tokenizer.eos_token_id]
        input_ids = prompt_ids + answer_ids
        labels = [IGNORE_INDEX] * len(prompt_ids) + answer_ids

        out = {
            "input_ids": input_ids,
            "labels": labels,
            "images": np.stack(slots),
            "view_mask": mask,
        }
        if "pc" in s and not drop():
            pts, valid = pp.pad_pointcloud(pp.load_pcd(s["pc"]), mcfg.ptv3.max_points)
            out["pc_points"], out["pc_valid"] = pts, valid
        if "audio" in s and not drop():
            emb = pp.load_audio_embedding(s["audio"])
            fitted = np.zeros((mcfg.pooler.audio_dim,), np.float32)
            n = min(len(emb), mcfg.pooler.audio_dim)
            fitted[:n] = emb[:n]
            out["audio_embedding"] = fitted
        if "segmasks" in s and not drop():
            from PIL import Image

            masks = np.zeros(
                (mcfg.pooler.num_segmask_tokens, mcfg.segmask.mask_size,
                 mcfg.segmask.mask_size), np.int32,
            )
            for k, p in enumerate(s["segmasks"][: mcfg.pooler.num_segmask_tokens]):
                masks[k] = np.asarray(Image.open(p).convert("L"), np.int32)
            out["segmasks"] = masks
        return out

    # ------------------------------------------------------------------ #

    def grouped_batches(self, batch_size: int, shuffle: bool = True):
        """Yield device-ready batches grouped by modality signature and
        length (llava_trainer.py:61-131)."""
        order = list(range(len(self)))
        if shuffle:
            self.rng.shuffle(order)
        order.sort(key=lambda i: (self.modality_signature(i), self.sample_length(i)))
        chunks = [order[i : i + batch_size] for i in range(0, len(order), batch_size)]
        if shuffle:
            self.rng.shuffle(chunks)
        for chunk in chunks:
            yield self.collate([self[i] for i in chunk])

    def collate(self, items: list[dict]) -> dict:
        mcfg = self.model_cfg
        bucket = self.cfg.prompt_bucket
        longest = max(len(it["input_ids"]) for it in items)
        while bucket < longest:
            bucket *= 2
        pad_id = self.tokenizer.pad_token_id
        ids, mask = left_pad_batch([it["input_ids"] for it in items], pad_id, bucket)
        labels, _ = left_pad_batch([it["labels"] for it in items], IGNORE_INDEX, bucket)
        labels = np.where(mask == 0, IGNORE_INDEX, labels)

        batch = {
            "input_ids": ids,
            "attention_mask": mask,
            "labels": labels,
            "images": np.stack([it["images"] for it in items]),
            "view_mask": np.stack([it["view_mask"] for it in items]),
        }
        b = len(items)
        if any("pc_points" in it for it in items):
            pts = np.zeros((b, mcfg.ptv3.max_points, 6), np.float32)
            valid = np.zeros((b, mcfg.ptv3.max_points), bool)
            for k, it in enumerate(items):
                if "pc_points" in it:
                    pts[k], valid[k] = it["pc_points"], it["pc_valid"]
            batch["pc_points"], batch["pc_valid"] = pts, valid
        if any("audio_embedding" in it for it in items):
            audio = np.zeros((b, mcfg.pooler.audio_dim), np.float32)
            for k, it in enumerate(items):
                if "audio_embedding" in it:
                    audio[k] = it["audio_embedding"]
            batch["audio_embedding"] = audio
        if any("segmasks" in it for it in items):
            seg = np.zeros(
                (b, mcfg.pooler.num_segmask_tokens, mcfg.segmask.mask_size,
                 mcfg.segmask.mask_size), np.int32,
            )
            for k, it in enumerate(items):
                if "segmasks" in it:
                    seg[k] = it["segmasks"]
            batch["segmasks"] = seg
        return batch


def photometric_augment(img, rng: random.Random):
    """TrivialAugment-style single-op photometric augmentation.

    The reference optionally wraps samples in torchvision's
    TrivialAugmentWide (`train.py:693-764`); this applies one randomly chosen
    op at a random strength — the policy's core idea — using PIL only.
    """
    from PIL import ImageEnhance, ImageOps

    op = rng.choice(["identity", "brightness", "contrast", "color",
                     "sharpness", "posterize", "solarize", "equalize"])
    strength = rng.random()
    if op == "identity":
        return img
    if op == "brightness":
        return ImageEnhance.Brightness(img).enhance(0.2 + 1.6 * strength)
    if op == "contrast":
        return ImageEnhance.Contrast(img).enhance(0.2 + 1.6 * strength)
    if op == "color":
        return ImageEnhance.Color(img).enhance(0.2 + 1.6 * strength)
    if op == "sharpness":
        return ImageEnhance.Sharpness(img).enhance(0.2 + 1.6 * strength)
    if op == "posterize":
        return ImageOps.posterize(img, 8 - int(strength * 6))
    if op == "solarize":
        return ImageOps.solarize(img, int(255 * (1 - strength)))
    return ImageOps.equalize(img)
