"""Host-side preprocessing: images (CLIP), point clouds (PCD), padding.

Copy of ``mmor_tpu/data/preprocessing.py``: the port imports nothing of the JAX
package, so it keeps its own copy of the host code it uses.

Replaces the reference's PIL/open3d per-sample loaders
(`mm_utils.py:15-40` expand2square + CLIP processor;
`scene_graph_prediction_model.py:126-127` open3d PCD read with /1000 scaling)
with dependency-free numpy implementations. The normalize/resize math stays
on host here; the fused on-device variant lives in ops/image_preproc.py.
"""

from __future__ import annotations

import re
import struct
from pathlib import Path

import numpy as np
from PIL import Image

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def expand2square(img: Image.Image, background: tuple[int, int, int]) -> Image.Image:
    """Pad to square with the background color (mm_utils.py:15-28)."""
    w, h = img.size
    if w == h:
        return img
    side = max(w, h)
    out = Image.new(img.mode, (side, side), background)
    if w > h:
        out.paste(img, (0, (w - h) // 2))
    else:
        out.paste(img, ((h - w) // 2, 0))
    return out


def clip_preprocess(img: Image.Image, image_size: int = 336) -> np.ndarray:
    """expand2square (mean-color background) + bicubic resize + normalize ->
    (H, W, 3) float32, matching the HF CLIP processor with LLaVA's
    image_aspect_ratio='pad'."""
    background = tuple(int(255 * m) for m in CLIP_MEAN)
    img = expand2square(img.convert("RGB"), background)
    img = img.resize((image_size, image_size), Image.BICUBIC)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def black_image(image_size: int = 336) -> np.ndarray:
    """Preprocessed all-black frame — the reference's missing-camera fallback
    (scene_graph_prediction_model.py:84-85, 101-105)."""
    return clip_preprocess(Image.new("RGB", (8, 8), (0, 0, 0)), image_size)


def load_pcd(path: str | Path) -> np.ndarray:
    """Parse a PCD file (ascii or binary, x/y/z[/rgb]) -> (N, 6) float32
    with xyz scaled by 1/1000 (millimetres -> metres) and rgb in [0, 1],
    matching the reference's open3d read + concat
    (scene_graph_prediction_model.py:126-127)."""
    raw = Path(path).read_bytes()
    header_end = raw.find(b"DATA")
    newline = raw.find(b"\n", header_end)
    header = raw[:newline].decode("ascii", errors="replace")
    body = raw[newline + 1:]

    fields = re.search(r"FIELDS (.+)", header).group(1).split()
    sizes = [int(s) for s in re.search(r"SIZE (.+)", header).group(1).split()]
    types = re.search(r"TYPE (.+)", header).group(1).split()
    n_points = int(re.search(r"POINTS (\d+)", header).group(1))
    mode = re.search(r"DATA (\w+)", header).group(1)

    if mode == "ascii":
        rows = np.loadtxt(body.decode("ascii").strip().splitlines(), dtype=np.float64)
        rows = rows.reshape(n_points, len(fields))
        cols = {f: rows[:, i] for i, f in enumerate(fields)}
    elif mode == "binary":
        np_map = {("F", 4): "<f4", ("F", 8): "<f8", ("U", 4): "<u4", ("I", 4): "<i4"}
        dtype = np.dtype([
            (f, np_map[(t, s)]) for f, t, s in zip(fields, types, sizes)
        ])
        arr = np.frombuffer(body[: n_points * dtype.itemsize], dtype=dtype)
        cols = {f: arr[f].astype(np.float64) for f in fields}
    else:
        raise ValueError(f"unsupported PCD data mode {mode!r}")

    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1) / 1000.0
    if "rgb" in cols:
        packed = np.asarray(
            [struct.unpack("I", struct.pack("f", v))[0] for v in cols["rgb"]],
            dtype=np.uint32,
        )
        colors = np.stack(
            [(packed >> 16) & 255, (packed >> 8) & 255, packed & 255], axis=-1
        ).astype(np.float32) / 255.0
    else:
        colors = np.zeros_like(xyz, dtype=np.float32)
    return np.concatenate([xyz, colors], axis=-1).astype(np.float32)


def pad_pointcloud(points: np.ndarray, capacity: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad/truncate to static capacity -> ((capacity, 6), (capacity,) bool)."""
    n = min(len(points), capacity)
    out = np.zeros((capacity, 6), dtype=np.float32)
    out[:n] = points[:n]
    valid = np.zeros((capacity,), dtype=bool)
    valid[:n] = True
    return out, valid


def load_audio_embedding(path: str | Path) -> np.ndarray:
    """Load a 512-d CLAP embedding. Supports numpy blobs (our artifact store)
    and torch .pt files when torch is importable (reference artifacts)."""
    path = Path(path)
    try:
        return np.load(path, allow_pickle=False).reshape(-1).astype(np.float32)
    except (ValueError, OSError):
        import torch

        t = torch.load(path, map_location="cpu", weights_only=True)
        return np.asarray(t, dtype=np.float32).reshape(-1)
