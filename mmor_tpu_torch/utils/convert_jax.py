"""Convert a JAX ``MM2SG`` parameter tree into the port's state dict.

The input is the JAX package's tree with numpy leaves (for example
``jax.tree.map(np.asarray, params)``), with or without the outer
``{"params": ...}``; this module imports no JAX. Layout rules:

- Dense kernels (in, out) -> ``weight`` (out, in);
- DenseGeneral q/k/v kernels (D, H, hd) -> (H*hd, D), biases (H, hd) ->
  (H*hd,); the out kernel (H, hd, D) -> (D, H*hd);
- Conv kernels HWIO -> OIHW; the PTv3 depthwise conv (3, 1, C) -> (C, 1, 3);
- Embed ``embedding`` -> ``weight``;
- the scanned ``blocks`` of the vision tower and the language model lose
  their leading layer axis to per-layer modules ``blocks.<i>``;
- the packed leaves (``w_p``, ``scale``) pass through unchanged: int8
  ``w_p`` (K/4, N) with ``scale`` (N,), and int4 ``w_p`` (K/8, N) with
  ``scale`` (K/group, N), for the fused ``qkv_proj`` / ``gate_up_proj`` too.

``convert_dvis`` maps the DVIS++ tree (``mmor_tpu.models.meta_arch.DVISPlus``)
onto ``mmor_tpu_torch.models.meta_arch.DVISPlus``: Dense kernels and conv
kernels as above, every other leaf (norm scales and biases, FrozenBN,
``level_embed``, ``query_feat``, ``query_embed``) as it is; the offline
refiner's subtree is skipped (not ported).

``convert_lora`` maps the JAX package's LoRA factors
(``mmor_tpu.train.lora.init_lora_params``: flat path keys, the scanned
decoder's factors stacked a (L, r, in), b (L, out, r)) onto the port's
per-layer weight names; the same function carries a gradient of those
factors across.

``mega_cache_from_jax`` builds the port's int4 decode cache from the values
of a JAX megakernel cache (for tests; the caller unpacks JAX's words).
"""

from __future__ import annotations

import numpy as np
import torch

_SCANNED = ("vision_tower/blocks", "language_model/blocks")
_DENSE_GENERAL_IN = ("query", "key", "value")


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _torch_key(path: str) -> str:
    parts = path.split("/")
    top = parts[0]
    if top == "point_encoder" and parts[1].startswith("down_"):
        parts.insert(1, "down")
    elif top == "point_encoder" and parts[1].startswith("stage"):
        parts.insert(1, "blocks")
    elif top == "image_pooler" and parts[1].startswith("layer_"):
        parts[1:2] = ["layers", parts[1][len("layer_"):]]
    return ".".join(parts)


def _convert_leaf(module: str, leaf: str, x: np.ndarray) -> tuple[str, np.ndarray]:
    if leaf == "embedding":
        return "weight", x
    if leaf == "kernel":
        if x.ndim == 4:  # conv HWIO -> OIHW
            return "weight", x.transpose(3, 2, 0, 1)
        if x.ndim == 3 and module == "cpe":  # depthwise conv1d (K, 1, C)
            return "weight", x.transpose(2, 1, 0)
        if x.ndim == 3 and module in _DENSE_GENERAL_IN:  # (D, H, hd)
            return "weight", x.reshape(x.shape[0], -1).T
        if x.ndim == 3 and module == "out":  # (H, hd, D)
            return "weight", x.reshape(-1, x.shape[-1]).T
        return "weight", x.T
    if leaf == "bias" and module in _DENSE_GENERAL_IN:
        return "bias", x.reshape(-1)
    return leaf, x


def convert_mm2sg(params: dict) -> dict[str, torch.Tensor]:
    """JAX MM2SG tree -> state dict for ``mmor_tpu_torch.models.mm2sg.MM2SG``
    (or, given a ``language_model`` subtree wrapped as
    ``{"language_model": ...}``, the keys of that submodule)."""
    tree = params.get("params", params)
    out: dict[str, torch.Tensor] = {}
    for path, x in _flatten(tree).items():
        scanned = next((p for p in _SCANNED if path.startswith(p + "/")), None)
        if scanned:
            rest = path[len(scanned) + 1:]
            per_layer = [(f"{scanned}/{i}/{rest}", x[i]) for i in range(x.shape[0])]
        else:
            per_layer = [(path, x)]
        for p, arr in per_layer:
            parts = p.split("/")
            module = parts[-2] if len(parts) > 1 else ""
            leaf, arr = _convert_leaf(module, parts[-1], arr)
            key = _torch_key("/".join(parts[:-1] + [leaf]))
            out[key] = _to_torch(arr)
    return out


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch twin in numpy
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable copy


def convert_llama(lm_params: dict) -> dict[str, torch.Tensor]:
    """JAX ``LlamaModel`` tree (float or packed int8) -> ``LlamaModel`` state
    dict."""
    inner = lm_params.get("params", lm_params)
    prefix = "language_model."
    full = convert_mm2sg({"language_model": inner})
    return {k[len(prefix):]: v for k, v in full.items()}


def convert_lora(lora: dict) -> dict[str, dict[str, torch.Tensor]]:
    """JAX LoRA factors {"params/.../kernel": {"a", "b"}} -> {port weight
    name: {"a" (r, in), "b" (out, r)}}, one entry a layer for the scanned
    decoder blocks. The factors' layouts already suit the port's (out, in)
    weights: JAX's delta a^T b^T is the transpose of b @ a."""
    out: dict[str, dict[str, torch.Tensor]] = {}
    for path, ab in lora.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        if parts[-1] != "kernel":
            raise ValueError(f"not a LoRA target kernel: {path}")
        p = "/".join(parts[:-1] + ["weight"])
        a, b = np.asarray(ab["a"]), np.asarray(ab["b"])
        scanned = next((s for s in _SCANNED if p.startswith(s + "/")), None)
        if scanned:
            rest = p[len(scanned) + 1:]
            for i in range(a.shape[0]):
                out[_torch_key(f"{scanned}/{i}/{rest}")] = {"a": _to_torch(a[i]),
                                                            "b": _to_torch(b[i])}
        else:
            out[_torch_key(p)] = {"a": _to_torch(a), "b": _to_torch(b)}
    return out


def convert_dvis(params: dict) -> dict[str, torch.Tensor]:
    """JAX ``DVISPlus`` tree -> state dict for the port's ``DVISPlus``."""
    tree = params.get("params", params)
    out: dict[str, torch.Tensor] = {}
    for path, x in _flatten(tree).items():
        parts = path.split("/")
        if parts[0] == "refiner":
            continue
        leaf = parts[-1]
        if leaf == "kernel":
            leaf, x = "weight", (x.transpose(3, 2, 0, 1) if x.ndim == 4 else x.T)
        out[".".join(parts[:-1] + [leaf])] = _to_torch(x)
    return out


def mega_cache_from_jax(k_int, k_scale, v_int, v_scale, kv_mask, write_pos: int,
                        tok_pos, kv_bits: int = 4) -> dict[str, torch.Tensor]:
    """The port's decode cache from a JAX megakernel cache, with
    ``k_scale``/``v_scale`` (L, H, B, T) as that cache stores them,
    ``kv_mask`` (B, T) and ``tok_pos`` (B,). ``kv_bits`` 4:
    ``k_int``/``v_int`` are (L, B, H, T, Dh) int4 values as
    ``mmor_tpu.ops.mega_decode.unpack_k_int4`` / ``unpack_v_int4`` return
    them, and the port keeps (L, B, H, T, Dh/2) nibble pairs. ``kv_bits`` 8:
    they are the cache's own int32 words, keys D-packed (L, B, H, Dh/4, T)
    (byte b of word r = channel 4r + b) and values T-packed (L, B, H, T/4,
    Dh) (byte b of word r = position 4r + b), and the port keeps (L, B, H,
    T, Dh) int8. Scales become (L, B, H, T) bf16 (``ops/mega_decode.py``)."""
    from mmor_tpu_torch.ops.mega_decode import pack_kv_int4

    def pack(values):
        if kv_bits == 8:
            return torch.from_numpy(np.ascontiguousarray(values))
        return pack_kv_int4(torch.from_numpy((np.asarray(values, np.int16) + 8)
                                             .astype(np.uint8)))

    if kv_bits == 8:
        # little-endian bytes of each word, then the packed axis moved inward
        kb = np.ascontiguousarray(k_int, np.int32).view(np.int8)  # (.., Dh/4, T * 4)
        *lead, d4, t4 = kb.shape
        k_int = kb.reshape(*lead, d4, t4 // 4, 4).swapaxes(-3, -2).reshape(
            *lead, t4 // 4, d4 * 4)
        vb = np.ascontiguousarray(v_int, np.int32).view(np.int8)  # (.., T/4, Dh * 4)
        *lead, t_4, d_4 = vb.shape
        v_int = vb.reshape(*lead, t_4, d_4 // 4, 4).swapaxes(-2, -1).reshape(
            *lead, t_4 * 4, d_4 // 4)

    def scales(s):
        return torch.from_numpy(np.asarray(s, np.float32).transpose(0, 2, 1, 3).copy()
                                ).to(torch.bfloat16)

    return dict(k=pack(k_int).contiguous(), k_s=scales(k_scale),
                v=pack(v_int).contiguous(), v_s=scales(v_scale),
                kv_mask=torch.from_numpy(np.asarray(kv_mask, np.int32).copy()),
                write_pos=int(write_pos),
                tok_pos=torch.from_numpy(np.asarray(tok_pos, np.int32).copy()))
