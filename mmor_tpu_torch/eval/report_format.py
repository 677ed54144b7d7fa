"""Console report formatting — the reference's classification_report surface.

Copy of ``mmor_tpu/eval/report_format.py``: the port imports nothing of the JAX
package, so it keeps its own copy of the host code it uses.

The reference prints sklearn classification reports per take, per datatype
and globally (`scene_graph_prediction_model.py:477-583`); this renders the
same tables from the structured SceneGraphEvaluator report.
"""

from __future__ import annotations

from mmor_tpu_torch.eval.sg_eval import CLASS_NAMES, RELATION_NAMES


def _table(metrics: dict, names) -> str:
    lines = [f"{'':>22} {'precision':>9} {'recall':>9} {'f1-score':>9} {'support':>9}"]
    for idx, name in enumerate(names):
        row = metrics["per_class"][idx]
        lines.append(
            f"{name:>22} {row['precision']:>9.4f} {row['recall']:>9.4f} "
            f"{row['f1']:>9.4f} {row['support']:>9d}"
        )
    lines.append("")
    for label, key in (("macro avg", "macro"), ("real macro", "real_macro")):
        m = metrics[key]
        lines.append(
            f"{label:>22} {m['precision']:>9.4f} {m['recall']:>9.4f} "
            f"{m['f1']:>9.4f} {metrics['total']:>9d}"
        )
    return "\n".join(lines)


def format_sg_report(report: dict, per_take: bool = True) -> str:
    """Human-readable dump mirroring the reference's console output."""
    parts: list[str] = []
    if per_take:
        for take, take_report in report["takes"].items():
            parts.append(f"\nTake {take}\n")
            parts.append(_table(take_report["relations"], RELATION_NAMES))
            bi = take_report["binary_interaction"]["real_macro"]
            ent = take_report["entities"]["real_macro"]
            parts.append(
                f"binary interaction F1 {bi['f1']:.4f} | entity F1 {ent['f1']:.4f}"
            )
    for dt, metrics in report["datatypes"].items():
        parts.append(f"\nData Type: {dt}\n")
        parts.append(_table(metrics, RELATION_NAMES))
    parts.append("\nGlobal\n")
    parts.append(_table(report["relations"], RELATION_NAMES))
    rm = report["relations"]["real_macro"]
    parts.append(
        f"Macro Precision: {rm['precision']:.3f}, Macro Recall: {rm['recall']:.3f}, "
        f"Macro F1: {rm['f1']:.3f}"
    )
    bi = report["binary_interaction"]["real_macro"]
    ent = report["entities"]["real_macro"]
    parts.append(f"Binary interaction F1: {bi['f1']:.4f}")
    parts.append(f"Entity F1: {ent['f1']:.4f}")
    return "\n".join(parts)
