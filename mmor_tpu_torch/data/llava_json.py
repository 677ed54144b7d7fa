"""Training-sample (conversation JSON) generators for MM2SG fine-tuning.

Copy of ``mmor_tpu/data/llava_json.py``: the port imports nothing of the JAX
package, so it keeps its own copy of the host code it uses.

Parity with the reference generators
(`scene_graph_prediction/llava_helpers/generate_dataset_format_for_llava.py`):

- GT triplets render as ``<SG> sub,obj,pred; ... </SG>`` with entities
  lowercased and underscores turned into spaces (`:29-41`);
- each sample emits ``n_permutations`` (default 20) random triplet orders;
- mixed-modality augmentation swaps audio/robot/tracker/transcript artifacts
  with those of a "similar sample" (`:137-150`);
- image path order: azure (2,1,3,5) 4D-OR / (1,4,5,2,3) MM-OR + simstation
  (2,0,1,3) + trackercam (`:120-130`);
- optional temporal memory: per-take change log from the GT graphs, rendered
  per sample with the 4-way style augmentation (none 50% / short / long /
  longshort, DROP_HISTORY dropout, `:254-263`);
- token frequencies over the assistant turns feed the CE vocab weights.
"""

from __future__ import annotations

import random
from collections import Counter
from typing import Callable, Sequence

from mmor_tpu_torch.data.configurations import TRACKER_OBJECT_MAP
from mmor_tpu_torch.sg.converters import (
    change_log_to_memory_str,
    parse_sg_string,
    sg_history_to_change_log,
)
from mmor_tpu_torch.sg.prompts import (
    SG_PROMPT,
    format_robot_metadata,
    format_tracker_metadata,
)


def scene_graph_to_string(relations: Sequence[Sequence[str]]) -> str:
    """GT (sub, obj, pred) triples -> the assistant answer string."""
    parts = []
    for sub, obj, pred in relations:
        parts.append(
            f"{sub.replace('_', ' ').lower()},{obj.replace('_', ' ').lower()},{pred}"
        )
    return "<SG> " + "; ".join(parts) + " </SG>" if parts else "<SG>  </SG>"


def _human_prompt(robot=None, tracker=None, transcript=None) -> str:
    prompt = SG_PROMPT
    if robot is not None:
        prompt = prompt.replace(
            "Entities: ", f"<robot_metadata_start>: {robot} <robot_metadata_end>. Entities: ", 1
        )
    if tracker is not None:
        prompt = prompt.replace(
            "Entities: ",
            f"<tracker_metadata_start>: {tracker} <tracker_metadata_end>. Entities: ", 1,
        )
    if transcript is not None:
        prompt = prompt.replace(
            "Entities: ",
            f"<speech_transcript_start>: {transcript} <speech_transcript_end>. Entities: ", 1,
        )
    return prompt


def generate_finetuning_samples(
    dataset,
    n_permutations: int = 20,
    mixed_modalities: bool = False,
    rng: random.Random | None = None,
    read_json: Callable | None = None,
) -> list[dict]:
    """ORDataset -> LLaVA-style conversation samples."""
    import json as _json
    from pathlib import Path

    rng = rng or random.Random()
    read_json = read_json or (lambda p: _json.loads(Path(p).read_text()))

    samples = []
    for index in range(len(dataset)):
        item = dataset[index]
        sample, md = item["sample"], dict(item["multimodal_data"])
        if not any(len(v) for v in md.values()):
            continue
        sample_id = sample["sample_id"]
        is_4dor = "4DOR" in sample_id

        image_paths: list = []
        azure = md.get("azure", [])
        simstation = md.get("simstation", [])
        trackercam = md.get("trackercam", [])
        azure_views = (2, 1, 3, 5) if is_4dor else (1, 4, 5, 2, 3)
        if azure:
            image_paths += [azure[v - 1] for v in azure_views if v - 1 < len(azure)]
        if simstation:
            image_paths += [simstation[v] for v in (2, 0, 1, 3) if v < len(simstation)]
        if trackercam:
            image_paths += trackercam[:1]

        if mixed_modalities and sample.get("similar_samples"):
            for key in set(md) & {"audio", "robot_metadata", "tracker", "speech_transcript"}:
                pick = rng.choice(sample["similar_samples"])
                other = dataset[pick["sample_idx"]]["multimodal_data"]
                if key in other:
                    md[key] = other[key]

        robot = tracker = transcript = None
        if md.get("robot_metadata"):
            robot = format_robot_metadata(read_json(md["robot_metadata"][0]))
        if md.get("tracker"):
            tracker = format_tracker_metadata(
                md["tracker"][0]["unique_id_dicts"], TRACKER_OBJECT_MAP
            )
        if md.get("speech_transcript"):
            transcript = read_json(md["speech_transcript"][0])["text"]
        prompt = _human_prompt(robot, tracker, transcript)

        relations = list(sample["relationships"])
        for _perm in range(n_permutations):
            rng.shuffle(relations)
            out = {
                "id": sample_id,
                "timepoint": int(sample["frame_id"]),
                "vis_knowledge_paths": None,
                "conversations": [
                    {"from": "human", "value": f"<image>\n{prompt}"},
                    {"from": "gpt", "value": scene_graph_to_string(relations)},
                ],
            }
            if image_paths:
                out["image"] = [str(p) for p in image_paths]
            if md.get("segmasks"):
                out["segmasks"] = [str(p) for p in md["segmasks"]]
            if md.get("pc"):
                out["pc"] = str(md["pc"][0])
            if md.get("audio"):
                out["audio"] = str(md["audio"][0])
            samples.append(out)
    return samples


def add_temporal_memory(
    samples: list[dict],
    with_augmentation: bool = True,
    drop_history: float = 0.5,
    rng: random.Random | None = None,
) -> tuple[list[dict], dict[str, str]]:
    """Augment generated samples with memory strings built from the takes'
    own GT graphs (generate_dataset_format_for_llava.py:216-270).

    Returns (samples, take_timepoint -> canonical longshort memory string).
    """
    rng = rng or random.Random()
    take_names = {s["id"].rsplit("_", 1)[0] for s in samples}
    take_to_log = {}
    for take in take_names:
        take_samples = {s["timepoint"]: s for s in samples
                        if s["id"].rsplit("_", 1)[0] == take}
        history = [
            {"timepoint_idx": tp,
             "scene_graph": parse_sg_string(s["conversations"][1]["value"])}
            for tp, s in sorted(take_samples.items())
        ]
        take_to_log[take] = sg_history_to_change_log(
            history, irrelevant_preds=["closeto", "closeTo"], rng=rng
        )

    memory_index: dict[str, str] = {}
    for s in samples:
        take = s["id"].rsplit("_", 1)[0]
        timepoint = s["timepoint"]
        log = [e for e in take_to_log[take] if e[0] < timepoint]
        memory = change_log_to_memory_str(log, timepoint, style="longshort")
        memory_index[f"{take}_{timepoint}"] = memory
        if with_augmentation:
            p = rng.random()
            if p < 0.5:
                memory = None
            else:
                style = ("short" if p < 0.666 else "long" if p < 0.833 else "longshort")
                memory = change_log_to_memory_str(
                    log, timepoint, style=style, drop_history=drop_history, rng=rng
                )
        if memory is not None:
            s["conversations"][0]["value"] = s["conversations"][0]["value"].replace(
                "<image>\n", f"<image>\n<memory_start>: {memory}<memory_end>.\n", 1
            )
    return samples, memory_index


def token_frequencies(samples: list[dict], tokenize: Callable[[str], list]) -> Counter:
    """Token counts over assistant turns (feeds build_vocab_weights)."""
    freq: Counter = Counter()
    for s in samples:
        for turn in s["conversations"]:
            if turn["from"] == "gpt":
                freq.update(tokenize(turn["value"]))
    return freq
