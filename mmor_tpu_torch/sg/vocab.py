"""Scene-graph vocabulary: entities, predicates, synonym normalization.

Copy of ``mmor_tpu/sg/vocab.py``: the port imports nothing of the JAX
package, so it keeps its own copy of the host code it uses.

Behavioral parity with the reference vocab maps
(`scene_graph_generation/.../dataset/dataset_utils.py:1-81`): 23 entity
classes (ids 0-22) followed by 16 predicate classes (ids 23-38), with
spelling-variant synonyms folded onto canonical names.
"""

from __future__ import annotations

# Entity classes, in vocab-id order (ids 0..22).
ENTITIES: tuple[str, ...] = (
    "anaesthetist",
    "anesthesia_equipment",
    "assistant_surgeon",
    "c_arm",
    "circulator",
    "drape",
    "drill",
    "hammer",
    "head_surgeon",
    "instrument",
    "instrument_table",
    "mako_robot",
    "monitor",
    "mps",
    "mps_station",
    "nurse",
    "operating_table",
    "patient",
    "saw",
    "secondary_table",
    "student",
    "tracker",
    "unrelated_person",
)

# Predicate classes, in vocab-id order (ids 23..38).
PREDICATES: tuple[str, ...] = (
    "assisting",
    "calibrating",
    "cementing",
    "cleaning",
    "closeto",
    "cutting",
    "drilling",
    "hammering",
    "holding",
    "lyingon",
    "manipulating",
    "preparing",
    "sawing",
    "scanning",
    "suturing",
    "touching",
)

VOCAB: dict[str, int] = {name: i for i, name in enumerate(ENTITIES + PREDICATES)}
ID_TO_NAME: dict[int, str] = {i: name for name, i in VOCAB.items()}

# Spelling variants seen in generated text, folded onto canonical names
# (reference `synonyms`, dataset_utils.py:45-56).
_SYNONYMS: dict[str, tuple[str, ...]] = {
    "anesthesia_equipment": (
        "anaesthesia_equipment",
        "anesthesia equipment",
        "anaesthetist_station",
    ),
    "closeto": ("close", "close to"),
    "instrument": ("tool",),
    "operating_table": ("opertating_table",),
}

# Role-name variants, applied to subjects/objects of parsed triplets before
# vocab mapping (reference `role_synonyms`, dataset_utils.py:52-56).
_ROLE_SYNONYMS: dict[str, tuple[str, ...]] = {
    "head_surgeon": ("head_surgent",),
    "anaesthetist": ("anesthetist",),
}

SYNONYM_TO_CANONICAL: dict[str, str] = {
    variant: canonical for canonical, variants in _SYNONYMS.items() for variant in variants
}
ROLE_SYNONYM_TO_CANONICAL: dict[str, str] = {
    variant: canonical
    for canonical, variants in _ROLE_SYNONYMS.items()
    for variant in variants
}


def vocab_id(name: str) -> int:
    """Map an entity/predicate name to its vocab id (case/synonym tolerant).

    Raises ``KeyError`` for out-of-vocabulary names — callers treat this as a
    nonsense prediction and drop it, matching the reference
    (`scene_graph_prediction_model.py:337-345`).
    """
    key = name.lower()
    key = SYNONYM_TO_CANONICAL.get(key, key)
    return VOCAB[key]


def name_from_vocab_id(idx: int) -> str:
    return ID_TO_NAME[idx]


def normalize_role(name: str) -> str:
    """Fold role-name spelling variants (e.g. ``anesthetist``) to canonical form."""
    return ROLE_SYNONYM_TO_CANONICAL.get(name, name)


def entity_id(name: str) -> int:
    """Vocab id restricted to entities; raises KeyError for predicates."""
    idx = vocab_id(name)
    if idx >= len(ENTITIES):
        raise KeyError(f"{name!r} is a predicate, not an entity")
    return idx
