"""Prompt assembly for MM2SG: conversation template, metadata injection, tokenization.

Copy of ``mmor_tpu/sg/prompts.py``: the port imports nothing of the JAX
package, so it keeps its own copy of the host code it uses.

Behavioral parity with the reference prompt path:
- vicuna-v1 chat template (``LLaVA/llava/conversation.py:253-263,361``);
- the fixed scene-graph instruction listing 22 entities / 16 predicates
  (``scene_graph_prediction_model.py:140``, ``generate_dataset_format_for_llava.py:44``);
- robot/tracker/transcript/memory side-channels spliced in as
  ``<x_start>: ... <x_end>`` text (``scene_graph_prediction_model.py:143-199``);
- ``<image>`` expansion to the sentinel token index -200
  (``LLaVA/llava/mm_utils.py:45-64``, ``constants.py:7-15``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
IMAGE_TOKEN = "<image>"

SYSTEM_PROMPT = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's questions."
)

# The fixed human instruction. Note the deliberate mixed naming style
# (spaces for roles/furniture, underscores for equipment) and that the entity
# list has 22 entries (`unrelated_person` is never prompted for).
SG_PROMPT = (
    "Entities: [head surgeon, assistant surgeon, circulator, nurse, anaesthetist, mps, "
    "patient, student, instrument table, operating table, secondary table, anesthesia "
    "equipment, c_arm, mako_robot, monitor, mps_station, tracker, drape, drill, hammer, "
    "saw, instrument]. Predicates: [assisting, calibrating, cementing, cleaning, closeTo, "
    "cutting, drilling, hammering, holding, lyingOn, manipulating, preparing, sawing, "
    "scanning, suturing, touching]. Given the following scene graph memory representation, "
    "generate a scene graph for timepoint T. The output should strictly be a list of "
    'triplets, each in the format "entity1,entity2,predicate;". Do not provide a narrative '
    "or descriptive text."
)


@dataclass
class VicunaConversation:
    """vicuna_v1 two-separator chat template (SeparatorStyle.TWO)."""

    system: str = SYSTEM_PROMPT
    roles: tuple[str, str] = ("USER", "ASSISTANT")
    sep: str = " "
    sep2: str = "</s>"
    messages: list[tuple[str, str | None]] = field(default_factory=list)

    def append(self, role: str, message: str | None) -> None:
        self.messages.append((role, message))

    def prompt(self) -> str:
        seps = (self.sep, self.sep2)
        out = self.system + seps[0]
        for i, (role, message) in enumerate(self.messages):
            if message is not None:
                out += f"{role}: {message}{seps[i % 2]}"
            else:
                out += f"{role}:"
        return out


def _inject(inp: str, tag: str, payload: str) -> str:
    """Splice a `<tag_start>: payload <tag_end>.` span immediately before the entity list."""
    return inp.replace("Entities: ", f"<{tag}_start>: {payload} <{tag}_end>. Entities: ", 1)


def format_robot_metadata(robot_metadata: Mapping[str, Mapping[str, str]]) -> str:
    """`type: template_name` pairs in sorted key order (scene_graph_prediction_model.py:144-151)."""
    parts = [
        f'{value["type"]}: {value["template_name"]}'
        for _key, value in sorted(robot_metadata.items())
    ]
    return ", ".join(parts)


def format_tracker_metadata(
    unique_id_dicts: Sequence[Mapping], tracker_object_map: Mapping[int, str]
) -> str:
    """Per-tool state/pose summary (scene_graph_prediction_model.py:155-168)."""
    parts = []
    for d in unique_id_dicts:
        name = tracker_object_map[d["unique_id"]]
        translation = " ".join(str(v) for v in np.asarray(d["Translation"]).astype(int))
        rotation = " ".join(str(v) for v in np.asarray(d["euler_rot"]).astype(int))
        parts.append(
            f'{name}: state {d["button_state"]}, translation {translation}, '
            f"euler angles {rotation}"
        )
    return "; ".join(parts)


def build_sg_prompt(
    robot_metadata_str: str | None = None,
    tracker_metadata_str: str | None = None,
    speech_transcript: str | None = None,
    memory_str: str | None = None,
    memory_clamp: int = 5000,
    answer: str | None = None,
) -> str:
    """Assemble the full generation prompt for one sample.

    Side-channels are injected in the reference order — robot, then tracker,
    then transcript, each splicing directly before ``Entities:``, so the final
    text reads robot, tracker, transcript, Entities — and the memory string
    follows the image token. ``answer=None`` leaves the assistant turn open
    for decoding.
    """
    inp = SG_PROMPT
    if robot_metadata_str is not None:
        inp = _inject(inp, "robot_metadata", robot_metadata_str)
    if tracker_metadata_str is not None:
        inp = _inject(inp, "tracker_metadata", tracker_metadata_str)
    if speech_transcript is not None:
        inp = _inject(inp, "speech_transcript", speech_transcript)
    inp = IMAGE_TOKEN + "\n" + inp
    if memory_str is not None:
        if len(memory_str) > memory_clamp:
            memory_str = "..." + memory_str[-memory_clamp:]
        inp = inp.replace(
            f"{IMAGE_TOKEN}\n", f"{IMAGE_TOKEN}\n<memory_start>: {memory_str}<memory_end>.\n", 1
        )
    conv = VicunaConversation()
    conv.append(conv.roles[0], inp)
    conv.append(conv.roles[1], answer)
    return conv.prompt()


def tokenize_with_image_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
) -> list[int]:
    """Tokenize a prompt, splicing ``image_token_index`` at each ``<image>``.

    Chunks around ``<image>`` are tokenized independently; the leading BOS of
    every chunk after the first is dropped (mm_utils.py:45-64).
    """
    chunks = [tokenizer.encode(c) for c in prompt.split(IMAGE_TOKEN)]
    ids: list[int] = []
    bos = getattr(tokenizer, "bos_token_id", None)
    offset = 1 if chunks and chunks[0] and bos is not None and chunks[0][0] == bos else 0
    if offset:
        ids.append(chunks[0][0])
    for i, chunk in enumerate(chunks):
        chunk = chunk[offset:] if bos is not None and chunk[:1] == [bos] else chunk
        if i > 0:
            ids.append(image_token_index)
        ids.extend(chunk)
    return ids


def left_pad_batch(
    sequences: Sequence[Sequence[int]], pad_id: int, max_len: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Left-pad variable-length token id lists into a dense (B, T) batch.

    Returns (ids, mask) with mask 1 on real tokens. Left padding matches the
    reference's batched generate path (scene_graph_prediction_model.py:207-214)
    and keeps the decode position static for the jitted sampler.
    """
    max_len = max_len or max(len(s) for s in sequences)
    batch = np.full((len(sequences), max_len), pad_id, dtype=np.int32)
    mask = np.zeros((len(sequences), max_len), dtype=np.int32)
    for i, seq in enumerate(sequences):
        seq = list(seq)[-max_len:]
        batch[i, max_len - len(seq):] = seq
        mask[i, max_len - len(seq):] = 1
    return batch, mask
