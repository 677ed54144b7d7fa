"""Triplet-string parsing and temporal scene-graph memory.

Copy of ``mmor_tpu/sg/converters.py``: the port imports nothing of the JAX
package, so it keeps its own copy of the host code it uses.

Behavioral parity with the reference converters
(`scene_graph_generation/scene_graph_prediction/llava_helpers/scene_graph_converters.py`):

- scene graphs are exchanged as ``<SG> e1,e2,pred; ... </SG>`` strings, where
  the *textual* order is (subject, object, predicate) but the in-memory tuple
  order is ``(subject, predicate, object)``;
- a surgery-long "change log" records only additions and ``not <pred>``
  removals per timepoint;
- memory strings come in styles ``all | long | short | longshort`` with an
  optional stochastic history dropout used as training augmentation.
"""

from __future__ import annotations

import random
import re
from typing import Iterable, Mapping, Sequence

Triplet = tuple[str, str, str]  # (subject, predicate, object)
TimedTriplet = tuple[int, Triplet]

_SG_RE = re.compile(r"<SG>(.*?)</SG>", re.DOTALL)


def parse_sg_string(text: str) -> list[Triplet]:
    """Parse a generated scene-graph string into (sub, pred, obj) triplets.

    Accepts either a full ``<SG>...</SG>`` block (preferred when present and
    well-ordered) or a bare ``;``-separated list. Entries that are not exactly
    three comma-separated fields are dropped. Mirrors
    ``parse_llava_sg`` (scene_graph_converters.py:96-112).
    """
    if "<SG>" in text and "</SG>" in text and text.index("<SG>") < text.index("</SG>"):
        body = text.split("<SG>")[1].split("</SG>")[0].strip()
    else:
        body = text
    triplets: list[Triplet] = []
    for chunk in body.split(";"):
        chunk = chunk.replace(".", "").replace("</s>", "").replace("<s>", "").strip()
        if not chunk:
            continue
        fields = [f.strip() for f in chunk.split(",")]
        if len(fields) != 3:
            continue
        sub, obj, pred = fields
        triplets.append((sub, pred, obj))
    return triplets


def triplets_to_sg_string(triplets: Iterable[Triplet]) -> str:
    """Serialize (sub, pred, obj) triplets into the ``<SG>`` wire format."""
    body = " ".join(f"{sub},{obj},{pred};" for sub, pred, obj in triplets)
    return f"<SG> {body} </SG>" if body else "<SG> </SG>"


def collapse_sgs(change_log: Sequence[TimedTriplet]) -> dict[tuple[str, str], str]:
    """Replay a change log into the current (sub, obj) -> pred state.

    ``not <pred>`` entries delete the (sub, obj) edge; later entries win.
    Mirrors ``collapse_sgs`` (scene_graph_converters.py:10-23).
    """
    state: dict[tuple[str, str], str] = {}
    for _timepoint, (sub, pred, obj) in change_log:
        if pred.startswith("not "):
            state.pop((sub, obj), None)
        else:
            state[(sub, obj)] = pred
    return state


def find_related_entities(
    scene_graph: Sequence[Triplet], entity_of_interest: str, multi_hop_n: int
) -> set[str]:
    """Entities reachable from ``entity_of_interest`` within ``multi_hop_n`` hops.

    Hop 0 returns just the entity itself. Mirrors ``find_related_entities``
    (scene_graph_converters.py:26-49).
    """

    def _expand(current: str, hop: int, visited: set[str]) -> set[str]:
        if hop > multi_hop_n:
            return set()
        visited = visited | {current}
        found: set[str] = {current} if hop == 0 else set()
        for sub, _pred, obj in scene_graph:
            if sub == current and obj not in visited and hop < multi_hop_n:
                found.add(obj)
                found |= _expand(obj, hop + 1, set(visited))
            elif obj == current and sub not in visited and hop < multi_hop_n:
                found.add(sub)
                found |= _expand(sub, hop + 1, set(visited))
        return found

    return _expand(entity_of_interest, 0, set())


def sg_history_to_change_log(
    sg_history: Sequence[Mapping],
    entity_of_interest: str | None = None,
    irrelevant_preds: Sequence[str] | None = None,
    rng: random.Random | None = None,
) -> list[TimedTriplet]:
    """Convert per-timepoint scene graphs into a surgery-long change log.

    Each history element is ``{'timepoint_idx': int, 'scene_graph': [triplets]}``.
    At every timepoint, edges that newly appear are logged as additions and
    edges that vanish are logged as ``not <pred>`` removals; entries within a
    timepoint are shuffled. Mirrors ``llava_sg_to_surgery_sg``
    (scene_graph_converters.py:52-89).
    """
    shuffle = (rng or random).shuffle
    log: list[TimedTriplet] = []
    for elem in sg_history:
        sg: Sequence[Triplet] = elem["scene_graph"]
        timepoint: int = elem["timepoint_idx"]
        prev = collapse_sgs(log)
        if entity_of_interest is None and irrelevant_preds is None:
            current = {
                (sub, obj): pred
                for sub, pred, obj in sg
                if sub != "none" and obj != "none"
            }
        elif entity_of_interest is None:
            current = {
                (sub, obj): pred
                for sub, pred, obj in sg
                if pred not in irrelevant_preds and sub != "none" and obj != "none"
            }
        else:
            related = find_related_entities(sg, entity_of_interest, multi_hop_n=0)
            current = {
                (sub, obj): pred
                for sub, pred, obj in sg
                if pred not in (irrelevant_preds or ())
                and (
                    sub == entity_of_interest
                    or obj == entity_of_interest
                    or sub in related
                    or obj in related
                )
            }
        changes: list[TimedTriplet] = []
        for (sub, obj), pred in current.items():
            if (sub, obj) not in prev:
                changes.append((timepoint, (sub, pred, obj)))
        for (sub, obj), pred in prev.items():
            if (sub, obj) not in current:
                changes.append((timepoint, (sub, f"not {pred}", obj)))
        shuffle(changes)
        log.extend(changes)
    return log


def change_log_to_memory_str(
    change_log: Sequence[TimedTriplet],
    current_timepoint: int,
    style: str = "longshort",
    drop_history: float | bool = False,
    rng: random.Random | None = None,
) -> str:
    """Render a change log as the textual memory injected into prompts.

    ``short`` keeps the last 5 changes verbatim (including ``not`` entries);
    ``long`` keeps the first occurrence of each non-``not`` action before the
    last 5; ``longshort`` concatenates both. ``drop_history`` (a probability)
    stochastically skips entries — training-time augmentation. Mirrors
    ``surgery_sg_to_memory_str`` (scene_graph_converters.py:115-174), including
    its trailing two-character strip.
    """
    rand = (rng or random).random
    parts: list[str] = []

    def _short() -> None:
        parts.append("Short: ")
        for _timepoint, (sub, pred, obj) in change_log[-5:]:
            if drop_history is not False and rand() < drop_history:
                continue
            parts.append(f"{sub},{obj},{pred}; ")

    def _long() -> None:
        parts.append("Long: ")
        seen: set[tuple[str, str, str]] = set()
        for _timepoint, (sub, pred, obj) in change_log[:-5]:
            if (sub, obj, pred) in seen or pred.startswith("not "):
                continue
            seen.add((sub, obj, pred))
            if drop_history is not False and rand() < drop_history:
                continue
            parts.append(f"{sub},{obj},{pred}; ")

    if style == "short":
        _short()
    elif style == "long":
        _long()
    elif style == "longshort":
        _long()
        _short()
    elif style == "all":
        for _timepoint, (sub, pred, obj) in change_log:
            if drop_history is not False and rand() < drop_history:
                continue
            parts.append(f"{sub},{obj},{pred}; ")
    else:
        raise ValueError(f"unknown memory style {style!r}")

    memory = "".join(parts)
    return memory[:-2] if memory else ""
