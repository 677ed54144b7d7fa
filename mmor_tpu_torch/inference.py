"""MM2SG inference engine: ORDataset items -> prompts -> batched generate -> F1.

Counterpart of ``mmor_tpu/inference.py``: the same camera-slot logic,
metadata prompts, left padding to a prompt bucket, cache capacities (16-
granular per-op; for the megakernel 256-granular with an int4 cache, 128
with an int8 one), ragged
megakernel batches padded to a multiple of 8 with repeated first rows,
recycled cache buffers per (batch, capacity), and the reference's report.
Raw uint8 frames go to the device at their native sizes and are
preprocessed there; point clouds go through PTv3. The host-side pieces
(prompts, PCD parsing, the evaluator) are the port's copies in ``sg``,
``data`` and ``eval``.
"""

from __future__ import annotations

import json
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from mmor_tpu_torch.data import preprocessing as pp
from mmor_tpu_torch.data.configurations import TRACKER_OBJECT_MAP
from mmor_tpu_torch.eval.sg_eval import SceneGraphEvaluator
from mmor_tpu_torch.sg.converters import change_log_to_memory_str, sg_history_to_change_log
from mmor_tpu_torch.sg.prompts import (
    IMAGE_TOKEN_INDEX,
    build_sg_prompt,
    format_robot_metadata,
    format_tracker_metadata,
    left_pad_batch,
    tokenize_with_image_token,
)
from mmor_tpu_torch.config import MM2SGConfig, require_device
from mmor_tpu_torch.models.llama import make_decode_step
from mmor_tpu_torch.models.mm2sg import MM2SG, generate_stepwise, make_prefill
from mmor_tpu_torch.ops.mega_decode import MegaServer, mega_granule

_BLACK = np.zeros((8, 8, 3), np.uint8)  # an absent view; any size will do


class ByteTokenizer:
    """UTF-8 byte fallback tokenizer: ids = byte + 3; 0/1/2 = pad/bos/eos.

    ``decode`` skips ids that stand for no byte (>= 259), which a model with
    a larger vocabulary, such as the 7b preset's 32000, can emit."""

    pad_token_id = 0
    bos_token_id = 1
    eos_token_id = 2
    vocab_size = 259

    def encode(self, text: str) -> list[int]:
        return [self.bos_token_id] + [b + 3 for b in text.encode("utf-8")]

    def decode(self, ids) -> str:
        data = bytes(i - 3 for i in ids if 3 <= i < self.vocab_size)
        return data.decode("utf-8", errors="replace")


@dataclass
class SceneGraphPredictor:
    cfg: MM2SGConfig
    model: MM2SG
    tokenizer: object
    device: torch.device | str = "cuda"  # "cpu" runs the plain versions
    cameras_mmor: tuple[int, ...] = (1, 4, 5, 2, 3)
    cameras_4dor: tuple[int, ...] = (2, 1, 3, 5)
    temporality: str | None = None  # None | 'PRED'
    prompt_bucket: int = 128
    take_to_history: dict = field(default_factory=lambda: defaultdict(list))

    def __post_init__(self):
        self.device = require_device(self.device)
        self._prefills: dict = {}
        self._buffers: dict = {}
        if self.cfg.llama.mega_decode:  # built once: weights, head, step buckets
            self._step = MegaServer(self.cfg.llama, self.model.language_model)
        else:
            self._step = make_decode_step(self.model.language_model)

    def _cache_len_for(self, prompt_len: int) -> int:
        need = (prompt_len + self.cfg.num_multimodal_tokens - 1
                + self.cfg.max_new_tokens)
        # the megakernel cache's granule (256 columns for int4 KV, 128 for
        # int8: constraints of the TPU kernel's lane tiling, kept so
        # capacities match the JAX package's); 16-granular otherwise
        granule = mega_granule(self.cfg.llama) if self.cfg.llama.mega_decode else 16
        return -(-need // granule) * granule

    def _generate(self, batch) -> np.ndarray:
        b = batch["input_ids"].shape[0]
        pad = (-b) % 8 if self.cfg.llama.mega_decode else 0
        if pad:
            # megakernel batches are multiples of 8 (the TPU kernel's row
            # groups, kept to match the JAX package's buckets): repeat the
            # first row and slice the outputs back
            def grow(a):
                if isinstance(a, tuple):
                    return tuple(grow(x) for x in a)
                if isinstance(a, torch.Tensor) and a.ndim >= 1 and a.shape[0] == b:
                    return torch.cat([a, a[:1].expand(pad, *a.shape[1:])])
                return a

            batch = {k: grow(v) for k, v in batch.items()}
        cache_len = self._cache_len_for(batch["input_ids"].shape[1])
        key = (batch["input_ids"].shape[0], cache_len)
        if key not in self._prefills:
            self._prefills[key] = make_prefill(self.model, max_cache_len=cache_len)
        tokens, bufs = generate_stepwise(
            self.model, batch, max_cache_len=cache_len,
            max_new_tokens=self.cfg.max_new_tokens,
            eos_token_id=self.tokenizer.eos_token_id,
            prefill_fn=self._prefills[key], step_fn=self._step,
            cache_buffers=self._buffers.pop(key, None))
        if bufs is not None:
            self._buffers[key] = bufs
        return tokens[:b]

    # ---------------------------------------------------------------- #
    # batch assembly
    # ---------------------------------------------------------------- #

    def _images_for(self, item) -> tuple[list[np.ndarray], np.ndarray]:
        """-> (V per-slot native uint8 frames, (V,) int32 view mask)."""
        md = item["multimodal_data"]
        sample = item["sample"]
        slots: list[np.ndarray] = []

        def load(path):
            from PIL import Image

            try:
                return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)
            except OSError:
                return _BLACK

        if "4DOR" in sample["take_name"]:
            azure = md.get("azure", [])
            for cam in self.cameras_4dor:
                slots.append(load(azure[cam - 1]) if cam - 1 < len(azure) else _BLACK)
        else:
            azure = md.get("azure", [])
            simstation = md.get("simstation", [])
            if azure:
                for cam in self.cameras_mmor:
                    slots.append(load(azure[cam - 1]) if cam - 1 < len(azure) else _BLACK)
            elif simstation:
                for cam in (2, 0, 3):
                    slots.append(load(simstation[cam]) if cam < len(simstation) else _BLACK)
            else:
                slots.extend(_BLACK for _ in self.cameras_mmor)
            if len(simstation) > 1:
                slots.append(load(simstation[1]))  # robot screen
            if md.get("trackercam"):
                slots.append(load(md["trackercam"][0]))

        v = self.cfg.pooler.max_views
        slots = slots[:v]
        mask = np.zeros((v,), np.int32)
        mask[: len(slots)] = 1
        slots += [_BLACK] * (v - len(slots))
        return slots, mask

    def _prompt_for(self, item) -> str:
        md = item["multimodal_data"]
        sample = item["sample"]
        robot = tracker = transcript = memory = None
        if md.get("robot_metadata"):
            with open(md["robot_metadata"][0]) as f:
                robot = format_robot_metadata(json.load(f))
        if md.get("tracker"):
            tracker = format_tracker_metadata(md["tracker"][0]["unique_id_dicts"],
                                              TRACKER_OBJECT_MAP)
        if md.get("speech_transcript"):
            with open(md["speech_transcript"][0]) as f:
                transcript = json.load(f)["text"]
        if self.temporality == "PRED":
            timepoint = int(sample["frame_id"])
            history = self.take_to_history[sample["take_name"]]
            log = sg_history_to_change_log(history, irrelevant_preds=["closeto", "closeTo"])
            log = [e for e in log if e[0] < timepoint]
            memory = change_log_to_memory_str(log, timepoint, style="longshort")
        return build_sg_prompt(robot_metadata_str=robot, tracker_metadata_str=tracker,
                               speech_transcript=transcript, memory_str=memory)

    def build_batch(self, items) -> dict:
        cfg = self.cfg
        images, view_masks, id_lists = [], [], []
        pcs, pc_valids, audios, has_pc = [], [], [], False
        for item in items:
            img, mask = self._images_for(item)
            images.append(img)
            view_masks.append(mask)
            id_lists.append(tokenize_with_image_token(
                self._prompt_for(item), self.tokenizer, IMAGE_TOKEN_INDEX))
            md = item["multimodal_data"]
            if md.get("pc"):
                pts, valid = pp.pad_pointcloud(pp.load_pcd(md["pc"][0]), cfg.ptv3.max_points)
                has_pc = True
            else:
                pts = np.zeros((cfg.ptv3.max_points, 6), np.float32)
                valid = np.zeros((cfg.ptv3.max_points,), bool)
            pcs.append(pts)
            pc_valids.append(valid)
            fitted = np.zeros((cfg.pooler.audio_dim,), np.float32)
            if md.get("audio"):  # fit to the configured width
                emb = pp.load_audio_embedding(md["audio"][0])
                n = min(len(emb), cfg.pooler.audio_dim)
                fitted[:n] = emb[:n]
            audios.append(fitted)

        bucket = self.prompt_bucket
        longest = max(len(ids) for ids in id_lists)
        while bucket < longest:
            bucket *= 2
        ids, mask = left_pad_batch(id_lists, self.tokenizer.pad_token_id, bucket)
        dev = self.device
        batch = {
            "input_ids": torch.from_numpy(ids).to(dev),
            "attention_mask": torch.from_numpy(mask).to(dev),
            "view_mask": torch.from_numpy(np.stack(view_masks)).to(dev),
            "audio_embedding": torch.from_numpy(np.stack(audios)).to(dev),
            "raw_views": self._stack_raw_views(images),
        }
        if has_pc:
            batch["pc_points"] = torch.from_numpy(np.stack(pcs)).to(dev)
            batch["pc_valid"] = torch.from_numpy(np.stack(pc_valids)).to(dev)
        return batch

    def _stack_raw_views(self, images: list[list[np.ndarray]]) -> tuple:
        """Per-slot (B, h_v, w_v, 3) uint8 stacks on the device. A slot's
        frames share one camera size within a dataset; a stray frame of
        another size is resized on the host to the slot's size."""
        out = []
        for slot in range(self.cfg.pooler.max_views):
            frames = [item_slots[slot] for item_slots in images]
            target = next((f.shape for f in frames if f.shape != _BLACK.shape),
                          frames[0].shape)
            fixed = []
            for f in frames:
                if f.shape != target:
                    if f.max() == 0:  # black placeholder: any size works
                        f = np.zeros(target, np.uint8)
                    else:
                        from PIL import Image

                        f = np.asarray(Image.fromarray(f).resize(
                            (target[1], target[0]), Image.BICUBIC), dtype=np.uint8)
                fixed.append(f)
            out.append(torch.from_numpy(np.stack(fixed)).to(self.device))
        return tuple(out)

    # ---------------------------------------------------------------- #
    # prediction / evaluation
    # ---------------------------------------------------------------- #

    def predict(self, items) -> list[str]:
        return self._decode_outputs(self.build_batch(items))

    def validate(self, items_iter, batch_size: int = 8,
                 limit_batches: int | None = None):
        """Generate over the dataset and produce the reference's report
        (per-take / per-datatype / global). Returns (report, raw predictions).
        Host batch assembly for batch i+1 overlaps generation of batch i,
        except in temporal-PRED mode, whose prompts depend on the previous
        output."""
        evaluator = SceneGraphEvaluator()
        raw_predictions: dict[str, list] = {}
        if self.temporality == "PRED":
            batch_size = 1  # history must be causal
        items = list(items_iter)
        chunks = [items[i:i + batch_size] for i in range(0, len(items), batch_size)]
        if limit_batches is not None:
            chunks = chunks[:limit_batches]

        def consume(batch_items, outputs):
            for item, text in zip(batch_items, outputs):
                sample = item["sample"]
                raw = evaluator.add_sample(sample["take_name"], text,
                                           sample["relationships"])
                raw_predictions[sample.get("sample_id", self._sid(sample))] = raw
                if self.temporality == "PRED":
                    self.take_to_history[sample["take_name"]].append(
                        {"timepoint_idx": int(sample["frame_id"]), "scene_graph": raw})

        if self.temporality == "PRED":
            for chunk in chunks:
                consume(chunk, self.predict(chunk))
        else:
            with ThreadPoolExecutor(max_workers=1) as pool:
                future = None
                for i, chunk in enumerate(chunks):
                    batch = future.result() if future is not None else self.build_batch(chunk)
                    future = (pool.submit(self.build_batch, chunks[i + 1])
                              if i + 1 < len(chunks) else None)
                    consume(chunk, self._decode_outputs(batch))
        return evaluator.report(), raw_predictions

    def _decode_outputs(self, batch) -> list[str]:
        tokens = self._generate(batch)
        eos = self.tokenizer.eos_token_id
        outputs = []
        for row in tokens:
            ids = list(row)
            if eos in ids:
                ids = ids[: ids.index(eos)]
            outputs.append(self.tokenizer.decode(ids).strip())
        return outputs

    @staticmethod
    def _sid(sample) -> str:
        return f'{sample["take_name"]}_{sample["frame_id"]}'
