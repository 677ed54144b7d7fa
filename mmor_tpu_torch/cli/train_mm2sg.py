"""MM2SG training CLI on the PyTorch port (``mmor_tpu.cli.train_mm2sg``'s twin).

LoRA (r=128 alpha=256) + fully-trained multimodal modules, token-weighted CE,
cosine schedule with warmup, periodic adapter/non-LoRA checkpoints with
auto-resume (train.py:1088-1363). Curriculum init (``--init_from``) loads a
previous run's final checkpoint before training (load_model_weights,
train.py:1053-1085). K1's gradient is the JAX package's: a recompute through
the plain attention (``ops/attention.py::flash_attention_bwd``).

Usage:
  python -m mmor_tpu_torch.cli.train_mm2sg --samples data/llava_samples/train.json \
      --run_dir runs/mm2sg [--preset small] [--steps 1000] [--device cuda]
  # smoke: --synthetic 2 --preset small --steps 3 --batch_size 2

Weights are random from a fixed seed, as in the JAX package's CLI. The run
needs a CUDA device unless ``--device cpu`` asks for the plain PyTorch
versions of the kernels (the ``tiny`` preset, which computes in f32, runs
only there).
"""

from __future__ import annotations

import argparse
import json
import random
import tempfile
from pathlib import Path

import numpy as np
import torch

from mmor_tpu_torch.cli.common import init_params, load_tokenizer, model_config
from mmor_tpu_torch.config import require_device
from mmor_tpu_torch.data.sg_train_data import SGTrainDataConfig, SGTrainDataset
from mmor_tpu_torch.models.mm2sg import MM2SG
from mmor_tpu_torch.train import trainer as tr
from mmor_tpu_torch.train.lora import LoraConfig
from mmor_tpu_torch.train.losses import build_vocab_weights
from mmor_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    load_train_checkpoint,
    save_train_checkpoint,
)


def load_samples(args) -> list[dict]:
    if args.synthetic:
        from mmor_tpu_torch.data.llava_json import (
            add_temporal_memory,
            generate_finetuning_samples,
        )
        from mmor_tpu_torch.data.or_dataset import ORDataset
        from mmor_tpu_torch.data.synthetic import build_synthetic_dataset

        paths = build_synthetic_dataset(
            Path(tempfile.mkdtemp(prefix="mmor_train_")), n_frames=args.synthetic)
        ds = ORDataset(split="train", data_path=paths["data_path"],
                       mmor_root=paths["mmor_root"], or4d_root=paths["or4d_root"])
        samples = generate_finetuning_samples(ds, n_permutations=2, rng=random.Random(0))
        samples, _ = add_temporal_memory(samples, rng=random.Random(0))
        return samples
    return json.loads(Path(args.samples).read_text())


def to_device(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """A collated numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def _copy_into(dst: dict, src: dict) -> None:
    with torch.no_grad():
        for name, t in src.items():
            if isinstance(t, dict):
                _copy_into(dst[name], t)
            else:
                dst[name].copy_(t)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--samples", default=None, help="conversation JSON")
    p.add_argument("--run_dir", default="runs/mm2sg")
    p.add_argument("--preset", default="tiny")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=4)  # README: 4 x accum 4
    p.add_argument("--grad_accum", type=int, default=4)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--lora_rank", type=int, default=128)
    p.add_argument("--lora_alpha", type=float, default=256.0)
    p.add_argument("--unfreeze_vision_layers", type=int, default=None,
                   help="train the last N CLIP layers (reference: 12)")
    p.add_argument("--token_freqs", default=None,
                   help="token-id frequency JSON for CE weighting")
    p.add_argument("--init_from", default=None, help="curriculum init run dir")
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ways (the reference: HF Trainer/DeepSpeed "
                        "multi-GPU); only 1 is ported")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.dp > 1:
        raise NotImplementedError("--dp > 1: data-parallel training is not ported yet "
                                  "(ROADMAP.md, Queue 1 item 8)")
    device = require_device(args.device)

    tokenizer = load_tokenizer(args.tokenizer)
    cfg = model_config(args.preset, tokenizer)
    if device.type == "cuda" and cfg.llama.dtype != torch.bfloat16:
        raise ValueError(f"preset {args.preset!r} computes in {cfg.llama.dtype}; the "
                         "CUDA kernels take bf16, so it runs only with --device cpu")
    with torch.device(device):
        model = MM2SG(cfg)
    init_params(model, 0)

    samples = load_samples(args)
    data = SGTrainDataset(samples, tokenizer, cfg, SGTrainDataConfig(),
                          rng=random.Random(42))

    vocab_weights = None
    if args.token_freqs:
        freqs = {int(k): v for k, v in
                 json.loads(Path(args.token_freqs).read_text()).items()}
        vocab_weights = torch.from_numpy(
            build_vocab_weights(freqs, cfg.llama.vocab_size)).to(device)

    tx = tr.make_optimizer(tr.TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                                          grad_accum=args.grad_accum))
    lora_cfg = LoraConfig(rank=args.lora_rank, alpha=args.lora_alpha)
    step_fn, state = tr.make_lora_train_step(
        model, tx, lora_cfg, vocab_weights=vocab_weights,
        vision_unfreeze_last_n=args.unfreeze_vision_layers)

    run_dir = Path(args.run_dir)
    start_step = 0
    resume = latest_checkpoint(run_dir)
    init_source = resume or (latest_checkpoint(args.init_from) if args.init_from else None)
    if init_source is not None:
        restored = load_train_checkpoint(init_source, map_location=device)
        _copy_into(state["lora"], restored.get("lora", {}))
        _copy_into(state["trainable"], restored.get("non_lora_trainables", {}))
        if resume is not None:  # only a same-run checkpoint advances the step
            start_step = restored["step"]
        print(f"initialized from {init_source} (step {start_step})")

    step, last = start_step, {}
    while step < args.steps:
        for batch in data.grouped_batches(args.batch_size):
            state, metrics = step_fn(state, to_device(batch, device))
            step += 1
            if step % 10 == 0 or step == args.steps:
                last = {"step": step, "loss": float(metrics["loss"]),
                        "grad_norm": float(metrics["grad_norm"])}
                print(json.dumps(last))
            if step % args.save_every == 0 or step == args.steps:
                save_train_checkpoint(run_dir, step, lora_params=state["lora"],
                                      non_lora_trainables=state["trainable"])
            if step >= args.steps:
                break
    print(f"done at step {step}; checkpoints in {run_dir}")
    return {"step": step, "start_step": start_step,
            "initialized_from": None if init_source is None else str(init_source), **last}


if __name__ == "__main__":
    main()
