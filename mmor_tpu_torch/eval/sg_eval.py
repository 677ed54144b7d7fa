"""Scene-graph triplet evaluation: per-take / per-datatype / global macro P/R/F1.

Copy of ``mmor_tpu/eval/sg_eval.py``: the port imports nothing of the JAX
package, so it keeps its own copy of the host code it uses.

Behavioral parity with the reference evaluator
(`scene_graph_prediction_model.py:311-585`):

- generated text is parsed into triplets, role synonyms folded, OOV names dropped;
- for every ordered pair of *ground-truth* entities, the GT predicate (or
  ``none``) is compared against the predicted predicate (or ``none``) —
  predictions between non-GT entities are never scored;
- the headline metric is the *support-filtered* ("real") macro F1 over the
  17 relation classes (16 predicates + ``none``), not sklearn's macro avg;
- secondary metrics: binary interaction-vs-none F1 and entity-detection F1.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence

import numpy as np

from mmor_tpu_torch.sg.converters import Triplet, parse_sg_string
from mmor_tpu_torch.sg.vocab import ENTITIES, name_from_vocab_id, normalize_role, vocab_id

# 16 predicate display names (data/relationships.txt) + 'none'
# (appended by ORDataset, or_dataset.py:49-50).
RELATION_NAMES: tuple[str, ...] = (
    "assisting",
    "calibrating",
    "cementing",
    "cleaning",
    "closeTo",
    "cutting",
    "drilling",
    "hammering",
    "holding",
    "lyingOn",
    "manipulating",
    "preparing",
    "sawing",
    "scanning",
    "suturing",
    "touching",
    "none",
)
RELATION_NAMES_LOWER: tuple[str, ...] = tuple(r.lower() for r in RELATION_NAMES)
CLASS_NAMES: tuple[str, ...] = ENTITIES  # 23 entity classes (data/classes.txt)

_NONE_ID = RELATION_NAMES_LOWER.index("none")


def classification_metrics(
    gts: Sequence[int], preds: Sequence[int], num_classes: int
) -> dict:
    """Per-class precision/recall/F1/support plus macro and support-filtered macro.

    Matches sklearn's `classification_report` semantics (0.0 for undefined
    ratios); "real macro" averages only over classes with support > 0
    (scene_graph_prediction_model.py:465-475).
    """
    gts = np.asarray(gts, dtype=np.int64)
    preds = np.asarray(preds, dtype=np.int64)
    per_class = {}
    real: dict[str, list[float]] = {"precision": [], "recall": [], "f1": []}
    macro: dict[str, list[float]] = {"precision": [], "recall": [], "f1": []}
    for c in range(num_classes):
        tp = int(np.sum((preds == c) & (gts == c)))
        fp = int(np.sum((preds == c) & (gts != c)))
        fn = int(np.sum((preds != c) & (gts == c)))
        support = tp + fn
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / support if support else 0.0
        f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
        per_class[c] = {
            "precision": precision,
            "recall": recall,
            "f1": f1,
            "support": support,
        }
        for key, value in (("precision", precision), ("recall", recall), ("f1", f1)):
            macro[key].append(value)
            if support:
                real[key].append(value)
    return {
        "per_class": per_class,
        "macro": {k: float(np.mean(v)) if v else 0.0 for k, v in macro.items()},
        "real_macro": {k: float(np.mean(v)) if v else 0.0 for k, v in real.items()},
        "accuracy": float(np.mean(gts == preds)) if len(gts) else 0.0,
        "total": int(len(gts)),
    }


def triplets_from_generation(text: str) -> list[Triplet]:
    """Parse generated text into raw triplets with role synonyms folded."""
    return [
        (normalize_role(sub), pred, normalize_role(obj))
        for sub, pred, obj in parse_sg_string(text)
    ]


def _to_vocab_ids(triplets: Iterable[Triplet]) -> list[tuple[int, int, int]]:
    """Map name triplets to vocab-id triplets, dropping any with OOV names."""
    out = []
    for sub, pred, obj in triplets:
        try:
            out.append(
                (
                    vocab_id(sub.replace(" ", "_")),
                    vocab_id(pred),
                    vocab_id(obj.replace(" ", "_")),
                )
            )
        except KeyError:
            continue
    return out


@dataclass
class SceneGraphEvaluator:
    """Accumulates predictions per take and produces the reference's reports."""

    take_rel_preds: dict[str, list[int]] = field(default_factory=lambda: defaultdict(list))
    take_rel_gts: dict[str, list[int]] = field(default_factory=lambda: defaultdict(list))
    take_bin_preds: dict[str, list[int]] = field(default_factory=lambda: defaultdict(list))
    take_bin_gts: dict[str, list[int]] = field(default_factory=lambda: defaultdict(list))
    take_entity_preds: dict[str, list[int]] = field(default_factory=lambda: defaultdict(list))
    take_entity_gts: dict[str, list[int]] = field(default_factory=lambda: defaultdict(list))

    def add_sample(
        self,
        take_name: str,
        generated_text: str,
        gt_relationships: Sequence[Sequence[str]],
    ) -> list[Triplet]:
        """Score one generated sample against GT ``(sub, obj, pred)`` name triples.

        GT relationships come in the annotation-JSON field order (sub, obj, pred)
        (`scene_graph_prediction_model.py:346-348`). Returns the raw parsed
        triplets (used by the temporal-PRED history).
        """
        raw_triplets = triplets_from_generation(generated_text)
        rel_preds = _to_vocab_ids(raw_triplets)
        rel_gts = [
            (vocab_id(sub), vocab_id(pred), vocab_id(obj))
            for sub, obj, pred in gt_relationships
        ]

        gt_entities = sorted({e for s, _p, o in rel_gts for e in (s, o)})
        pred_entities = sorted({e for s, _p, o in rel_preds for e in (s, o)})

        for e in gt_entities:
            self.take_entity_gts[take_name].append(
                CLASS_NAMES.index(name_from_vocab_id(e))
            )
            self.take_entity_preds[take_name].append(
                CLASS_NAMES.index(name_from_vocab_id(e)) if e in pred_entities else -1
            )

        for sub in gt_entities:
            for obj in gt_entities:
                if sub == obj:
                    continue
                gt_rel = next(
                    (p for s, p, o in rel_gts if s == sub and o == obj), None
                )
                if gt_rel is not None:
                    self.take_rel_gts[take_name].append(
                        RELATION_NAMES_LOWER.index(name_from_vocab_id(gt_rel))
                    )
                    self.take_bin_gts[take_name].append(1)
                else:
                    self.take_rel_gts[take_name].append(_NONE_ID)
                    self.take_bin_gts[take_name].append(0)
                pred_rel = next(
                    (p for s, p, o in rel_preds if s == sub and o == obj), None
                )
                if pred_rel is not None:
                    try:
                        rel_id = RELATION_NAMES_LOWER.index(name_from_vocab_id(pred_rel))
                        self.take_bin_preds[take_name].append(1)
                    except ValueError:
                        rel_id = _NONE_ID
                        self.take_bin_preds[take_name].append(0)
                    self.take_rel_preds[take_name].append(rel_id)
                else:
                    self.take_rel_preds[take_name].append(_NONE_ID)
                    self.take_bin_preds[take_name].append(0)
        return raw_triplets

    @staticmethod
    def _datatype(take_name: str) -> str:
        return "4DOR" if "4DOR" in take_name else "MMOR"

    def report(self) -> dict:
        """Per-take, per-datatype and global reports; headline = global real-macro F1."""
        out: dict = {"takes": {}, "datatypes": {}}
        all_rel_gts: list[int] = []
        all_rel_preds: list[int] = []
        all_bin_gts: list[int] = []
        all_bin_preds: list[int] = []
        all_ent_gts: list[int] = []
        all_ent_preds: list[int] = []
        by_dt: dict[str, dict[str, list[int]]] = defaultdict(lambda: defaultdict(list))

        for take in sorted(self.take_rel_preds):
            rel_gts = self.take_rel_gts[take]
            rel_preds = self.take_rel_preds[take]
            out["takes"][take] = {
                "relations": classification_metrics(rel_gts, rel_preds, len(RELATION_NAMES)),
                "binary_interaction": classification_metrics(
                    self.take_bin_gts[take], self.take_bin_preds[take], 2
                ),
                "entities": classification_metrics(
                    self.take_entity_gts[take], self.take_entity_preds[take], len(CLASS_NAMES)
                ),
            }
            dt = self._datatype(take)
            by_dt[dt]["rel_gts"].extend(rel_gts)
            by_dt[dt]["rel_preds"].extend(rel_preds)
            all_rel_gts.extend(rel_gts)
            all_rel_preds.extend(rel_preds)
            all_bin_gts.extend(self.take_bin_gts[take])
            all_bin_preds.extend(self.take_bin_preds[take])
            all_ent_gts.extend(self.take_entity_gts[take])
            all_ent_preds.extend(self.take_entity_preds[take])

        for dt, acc in by_dt.items():
            out["datatypes"][dt] = classification_metrics(
                acc["rel_gts"], acc["rel_preds"], len(RELATION_NAMES)
            )

        relations = classification_metrics(all_rel_gts, all_rel_preds, len(RELATION_NAMES))
        out["relations"] = relations
        out["binary_interaction"] = classification_metrics(all_bin_gts, all_bin_preds, 2)
        out["entities"] = classification_metrics(all_ent_gts, all_ent_preds, len(CLASS_NAMES))
        out["macro_f1"] = relations["real_macro"]["f1"]
        return out
