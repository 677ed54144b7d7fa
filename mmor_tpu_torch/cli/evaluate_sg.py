"""Scene-graph evaluation CLI on the PyTorch port (``mmor_tpu.cli.evaluate_sg``'s twin).

Modes:
- ``evaluate``: run the predictor over the split and print the report;
- ``eval_all``: sweep every ``checkpoint-*`` state dict under --run_dir,
  skipping those recorded in ``evaluated_checkpoints.json``;
- ``infer``: dump the raw predicted scene graphs to JSON.

Usage:
  python -m mmor_tpu_torch.cli.evaluate_sg --synthetic 2 --preset 7b \
      --quantize int4 [--batch_size 8] [--device cuda]

With --synthetic N a synthetic dataset is fabricated; without --checkpoint
the weights are random from a fixed seed. The run needs a CUDA device unless
``--device cpu`` asks for the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from mmor_tpu_torch.cli.common import build_predictor, load_tokenizer, make_dataset
from mmor_tpu_torch.config import require_device


def summarize(report: dict) -> dict:
    return {
        "macro_f1": report["macro_f1"],
        "precision": report["relations"]["real_macro"]["precision"],
        "recall": report["relations"]["real_macro"]["recall"],
        "binary_interaction_f1": report["binary_interaction"]["real_macro"]["f1"],
        "entity_f1": report["entities"]["real_macro"]["f1"],
        "datatypes": {dt: r["real_macro"]["f1"] for dt, r in report["datatypes"].items()},
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["evaluate", "eval_all", "infer"], default="evaluate")
    p.add_argument("--data_path", default="data")
    p.add_argument("--split", default="test")
    p.add_argument("--preset", default="tiny")
    p.add_argument("--checkpoint", default=None, help="torch state dict of MM2SG")
    p.add_argument("--run_dir", default=None, help="for eval_all sweeps")
    p.add_argument("--tokenizer", default=None, help="HF tokenizer dir (optional)")
    p.add_argument("--temporality", default=None, choices=[None, "PRED"])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--limit_batches", type=int, default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="fabricate a synthetic dataset with N frames")
    p.add_argument("--output", default=None)
    p.add_argument("--quantize", nargs="?", const="int8", default=None,
                   choices=["int8", "int4"],
                   help="'int8' (or the bare flag): packed int8 weights + int8 "
                        "KV cache, per-op decode; 'int4': fused int4 weights "
                        "(K3) + int4 KV cache, decode through the megakernel "
                        "(K5); where the model's K-chunk is not a multiple of "
                        "256 (the tiny preset, which runs only with --device "
                        "cpu) int4 weights with an int8 KV cache and per-op "
                        "decode")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) or 'cpu', "
                        "which runs the kernels' plain PyTorch versions")
    p.add_argument("--verbose", action="store_true",
                   help="print the reference-style per-take tables")
    args = p.parse_args(argv)
    require_device(args.device)

    dataset = make_dataset(args)
    tokenizer = load_tokenizer(args.tokenizer)

    def run(checkpoint):
        predictor = build_predictor(args.preset, tokenizer, checkpoint,
                                    temporality=args.temporality,
                                    quantize=args.quantize, device=args.device)
        items = [dataset[i] for i in range(len(dataset))]
        return predictor.validate(items, batch_size=args.batch_size,
                                  limit_batches=args.limit_batches)

    if args.mode == "eval_all":
        run_dir = Path(args.run_dir)
        record_path = run_dir / "evaluated_checkpoints.json"
        done = json.loads(record_path.read_text()) if record_path.exists() else []
        summaries = {}
        for ckpt in sorted(run_dir.glob("checkpoint-*")):
            if ckpt.name in done:
                continue
            report, _ = run(ckpt)
            summaries[ckpt.name] = summarize(report)
            print(json.dumps({ckpt.name: summaries[ckpt.name]}, indent=2))
            done.append(ckpt.name)
            record_path.write_text(json.dumps(done))
        return summaries

    report, raw = run(args.checkpoint)
    if args.verbose:
        from mmor_tpu_torch.eval.report_format import format_sg_report

        print(format_sg_report(report))
    summary = summarize(report)
    print(json.dumps(summary, indent=2))
    if args.mode == "infer":
        out = Path(args.output or "scene_graph_predictions.json")
        out.write_text(json.dumps({sid: [list(t) for t in triplets]
                                   for sid, triplets in raw.items()}))
        print(f"wrote raw predictions to {out}")
    return summary


if __name__ == "__main__":
    main()
