"""ORDataset: path-only multimodal dataset for the scene-graph stack.

Copy of ``mmor_tpu/data/or_dataset.py``: the port imports nothing of the JAX
package, so it keeps its own copy of the host code it uses.

Parity with the reference ``ORDataset``
(`scene_graph_helpers/dataset/or_dataset.py:14-304`): per-take timestamp
indexes resolve each (take, frame) to per-modality artifact paths — azure
cams (6 for 4D-OR, 5 for MM-OR), simstation (4), trackercam, sparse point
cloud, CLAP audio embedding, speech-transcript JSON, robot screen summary,
tracker pose record, and 32x32 segmask PNGs (reference quirk preserved:
``__getitem__`` does NOT load segmasks by default, or_dataset.py:302-303).
Train split precomputes "similar samples" by tiered predicate matching for
mixed-modality augmentation.
"""

from __future__ import annotations

import json
import random
from collections import defaultdict
from pathlib import Path

from mmor_tpu_torch.data import configurations as C

MOST_DISTINCTIVE = {"calibrating", "cementing", "cleaning", "cutting", "drilling",
                    "hammering", "sawing", "scanning", "suturing"}
DISTINCTIVE = {"assisting", "holding", "manipulating", "preparing", "touching"}
LESS_DISTINCTIVE = {"closeTo", "lyingOn"}


class ORDataset:
    def __init__(
        self,
        split: str = "train",
        data_path: str | Path = "data",
        mmor_root: Path | None = None,
        or4d_root: Path | None = None,
        load_4dor: bool = True,
        load_mmor: bool = True,
        compute_similar_samples: bool | None = None,
        use_gt_segmasks: bool = False,
        rng: random.Random | None = None,
    ):
        assert split in ("train", "val", "test")
        self.split = split
        self.data_path = Path(data_path)
        self.mmor_root = mmor_root if mmor_root is not None else C.mmor_data_root()
        self.or4d_root = or4d_root if or4d_root is not None else C.or4d_data_root()
        self.use_gt_segmasks = use_gt_segmasks
        self._rng = rng or random

        self.take_to_timestamps: dict[str, list] = {}
        self.take_to_trackertracks: dict[str, list] = {}
        if load_4dor:
            for take in C.OR4D_TAKE_NAMES:
                p = (self.or4d_root / C.OR4D_TAKE_NAME_TO_FOLDER[take]
                     / "timestamp_to_pcd_and_frames_list.json")
                if p.exists():
                    self.take_to_timestamps[take] = json.loads(p.read_text())
        if load_mmor:
            for take in C.MMOR_TAKE_NAMES:
                folder = self.mmor_root / C.MMOR_TAKE_NAME_TO_FOLDER.get(take, take)
                p = folder / f"timestamp_to_pcd_and_frames_list_{take}.json"
                if not p.exists():
                    p = folder / "timestamp_to_pcd_and_frames_list.json"
                if p.exists():
                    self.take_to_timestamps[f"{take}_MMOR"] = json.loads(p.read_text())
                tracks = self.mmor_root / "take_tracks" / f"{take}.json"
                if tracks.exists():
                    self.take_to_trackertracks[take] = json.loads(tracks.read_text())

        ann = ("relationships_validation.json" if split == "val"
               else f"relationships_{split}.json")
        with (self.data_path / ann).open() as f:
            self.samples = json.load(f)
        if not load_4dor:
            self.samples = [s for s in self.samples if "4DOR" not in s["take_name"]]
        if not load_mmor:
            self.samples = [s for s in self.samples if "MMOR" not in s["take_name"]]

        if compute_similar_samples is None:
            compute_similar_samples = split == "train"
        if compute_similar_samples:
            self._attach_similar_samples()

    def __len__(self) -> int:
        return len(self.samples)

    # ------------------------------------------------------------------ #
    # similar-sample precomputation (or_dataset.py:62-167)
    # ------------------------------------------------------------------ #

    def _attach_similar_samples(self) -> None:
        cache_path = self.data_path / f"sample_to_similar_samples_{self.split}.json"
        if cache_path.exists():
            mapping = json.loads(cache_path.read_text())
        else:
            pred_cache = {}
            for s in self.samples:
                d: dict[str, set] = defaultdict(set)
                for sub, obj, pred in s["relationships"]:
                    d[pred].add((sub, obj))
                pred_cache[self._sid(s)] = d
            mapping = {
                self._sid(s): self._similar_samples(s, pred_cache)
                for s in self.samples
            }
            try:
                cache_path.write_text(json.dumps(mapping))
            except OSError:
                pass
        sid_to_idx = {self._sid(s): i for i, s in enumerate(self.samples)}
        for s in self.samples:
            s["similar_samples"] = [
                {"sample_str": sid, "sample_idx": sid_to_idx[sid]}
                for sid in mapping.get(self._sid(s), [])
                if sid in sid_to_idx
            ]

    @staticmethod
    def _sid(sample) -> str:
        return f'{sample["take_name"]}_{sample["frame_id"]}'

    def _similar_samples(self, sample, cache) -> list[str]:
        """Tiered predicate-set matching: a sample matches another when its
        most-distinctive predicate set (falling back to distinctive, then
        less-distinctive) agrees and shares at least one (sub, obj) per
        matched predicate; capped at 20, sampled diversely across takes."""
        sid = self._sid(sample)
        dataset_type = "4DOR" if "4DOR" in sample["take_name"] else "MMOR"
        preds = cache[sid]
        most = MOST_DISTINCTIVE & preds.keys()
        dist = DISTINCTIVE & preds.keys()
        less = LESS_DISTINCTIVE & preds.keys()
        tier = ("most" if most else "dist" if dist else "less" if less else None)

        matches: list[str] = []
        groups: dict[str, list[str]] = defaultdict(list)
        for other in self.samples:
            osid = self._sid(other)
            other_type = "4DOR" if "4DOR" in other["take_name"] else "MMOR"
            if osid == sid or other_type != dataset_type:
                continue
            opreds = cache[osid]
            omost = MOST_DISTINCTIVE & opreds.keys()
            odist = DISTINCTIVE & opreds.keys()
            oless = LESS_DISTINCTIVE & opreds.keys()
            if tier == "most":
                if most != omost:
                    continue
                required = most
            elif tier == "dist":
                if most != omost or dist != odist:
                    continue
                required = dist
            elif tier == "less":
                if most != omost or dist != odist or less != oless:
                    continue
                required = less
            else:
                if preds.keys() != opreds.keys():
                    continue
                required = set()
            if any(not (preds[p] & opreds[p]) for p in required):
                continue
            matches.append(osid)
            groups[other["take_name"]].append(osid)

        cap = 20
        if len(matches) > cap:
            base, extra = divmod(cap, len(groups))
            picked = []
            for i, (_take, sids) in enumerate(groups.items()):
                n = base + (1 if i < extra else 0)
                picked += self._rng.sample(sids, min(n, len(sids)))
            matches = picked
        return matches

    # ------------------------------------------------------------------ #
    # per-modality path resolution (or_dataset.py:171-295)
    # ------------------------------------------------------------------ #

    def _entry(self, sample):
        return self.take_to_timestamps[sample["take_name"]][int(sample["frame_id"])]

    def multimodal_data(
        self,
        sample,
        azure=True, simstation=True, trackercam=True, pc=True, audio=True,
        speech_transcript=True, robot_metadata=True, tracking=True,
        segmasks=False,
    ) -> dict:
        out: dict = {}
        take = sample["take_name"]
        is_4dor = "4DOR" in take
        base_take = take.replace("_MMOR", "")
        mm_folder = self.mmor_root / C.MMOR_TAKE_NAME_TO_FOLDER.get(base_take, base_take)
        entry = self._entry(sample)
        timestamp_idx = entry[0]
        frames = entry[1]

        if azure:
            paths = []
            if is_4dor:
                folder = self.or4d_root / C.OR4D_TAKE_NAME_TO_FOLDER.get(take, take)
                for c in range(1, 7):
                    p = folder / "colorimage" / (
                        f'camera0{c}_colorimage-{frames[f"color_{c}"]}.jpg'
                    )
                    if p.exists():
                        paths.append(p)
            else:
                for c in range(1, 6):
                    p = mm_folder / "colorimage" / (
                        f'camera0{c}_colorimage-{frames["azure"]}.jpg'
                    )
                    if p.exists():
                        paths.append(p)
            out["azure"] = paths

        if not is_4dor:
            if simstation and "simstation" in frames:
                paths = [
                    mm_folder / "simstation" / f'camera0{i}_{frames["simstation"]}.jpg'
                    for i in range(4)
                ]
                out["simstation"] = [p for p in paths if p.exists()]
            if trackercam and "trackercam" in frames:
                p = mm_folder / "trackercam" / f'{frames["trackercam"]}.jpg'
                out["trackercam"] = [p] if p.exists() else []
            if audio:
                p = (self.mmor_root / "take_audio_embeddings_per_timepoint"
                     / base_take / f"{timestamp_idx}.pt")
                if p.exists():
                    out["audio"] = [p]
                raw = (self.mmor_root / "take_audio_per_timepoint" / base_take
                       / f"{timestamp_idx}.mp3")
                if raw.exists():
                    out["raw_audio"] = [raw]
            if speech_transcript:
                p = (self.mmor_root / "take_transcripts_per_timepoint" / base_take
                     / f"{timestamp_idx}.json")
                if p.exists():
                    out["speech_transcript"] = [p]
            if robot_metadata and "simstation" in frames:
                p = (self.mmor_root / "screen_summaries" / base_take
                     / f'{frames["simstation"]}.json')
                if p.exists():
                    out["robot_metadata"] = [p]
            if tracking and base_take in self.take_to_trackertracks:
                out["tracker"] = [
                    self.take_to_trackertracks[base_take][int(timestamp_idx)]
                ]

        if pc:
            if is_4dor:
                folder = self.or4d_root / C.OR4D_TAKE_NAME_TO_FOLDER.get(take, take)
                p = folder / "pcds_sparse" / f'{frames["pcd"]}.pcd'
            else:
                p = (self.mmor_root / "take_point_clouds_sparse" / base_take
                     / f"{timestamp_idx}.pcd")
            if p.exists():
                out["pc"] = [p]

        if segmasks:
            root = self.or4d_root if is_4dor else self.mmor_root
            seg_take = take if is_4dor else base_take
            folder = root / "take_segmasks_per_timepoint" / seg_take
            found = []
            for i in range(3):
                p = folder / f"{timestamp_idx}_{i}_GT{self.use_gt_segmasks}.png"
                if p.exists():
                    found.append(p)
            if found:
                out["segmasks"] = found

        return out

    def __getitem__(self, index: int) -> dict:
        sample = dict(self.samples[index])
        sample["sample_id"] = self._sid(sample)
        # segmasks intentionally not loaded (reference quirk, or_dataset.py:302)
        return {
            "sample": sample,
            "multimodal_data": self.multimodal_data(sample, segmasks=False),
        }
