"""Training losses for MM2SG: token-weighted causal LM cross-entropy.

Counterpart of ``mmor_tpu/train/losses.py``: the reference's custom
``compute_loss`` (`LLaVA/llava/train/llava_trainer.py:136-174`), shifted CE
over the spliced labels with a per-vocab-class weight vector, normalized as
the weighted mean over non-ignored targets (torch
``CrossEntropyLoss(weight=...)`` semantics). Vocab weights follow
`train.py:1310-1327`: ``1/(ln(freq)+1)`` for counted tokens and
``min_weight/100`` for everything else.
"""

from __future__ import annotations

import numpy as np
import torch

from mmor_tpu_torch.sg.prompts import IGNORE_INDEX


def build_vocab_weights(
    token_freqs: dict[int, float] | None, vocab_size: int
) -> np.ndarray | None:
    """Per-vocab-id CE weights from token-id frequency counts.

    ``token_freqs`` maps token id -> count (the reference maps token *strings*
    through the tokenizer vocab first; do that upstream).
    """
    if not token_freqs:
        return None
    weights_by_id = {tid: 1.0 / (np.log(c) + 1.0) for tid, c in token_freqs.items()}
    extra = min(weights_by_id.values()) / 100.0
    weights = np.full((vocab_size,), extra, dtype=np.float32)
    for tid, w in weights_by_id.items():
        weights[tid] = w
    return weights


def token_weighted_ce(
    logits: torch.Tensor,  # (B, T, V)
    labels: torch.Tensor,  # (B, T); IGNORE_INDEX positions excluded
    vocab_weights: torch.Tensor | None = None,  # (V,)
) -> torch.Tensor:
    """Shifted causal-LM CE, weighted-mean normalized like torch CE."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe_labels = torch.where(valid, shift_labels, torch.zeros_like(shift_labels)).long()
    logp = torch.log_softmax(shift_logits, dim=-1)
    nll = -torch.gather(logp, -1, safe_labels[..., None])[..., 0]
    w = vocab_weights[safe_labels] if vocab_weights is not None else torch.ones_like(nll)
    w = w * valid
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1e-8)
