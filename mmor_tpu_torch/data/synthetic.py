"""Synthetic mini dataset: a fake MM-OR + 4D-OR tree for tests and smoke runs.

Copy of ``mmor_tpu/data/synthetic.py``: the port imports nothing of the JAX
package, so it keeps its own copy of the host code it uses.

Plays the role of the reference's ``mini_train`` debug splits (SURVEY.md §4):
generates per-take timestamp indexes, camera JPGs, sparse point clouds,
transcripts, robot summaries, tracker tracks, audio embeddings and
relationship annotations with the real on-disk layout, so the data layer and
end-to-end smoke tests run without the (unreleasable) datasets.
"""

from __future__ import annotations

import json
import random
import struct
from pathlib import Path

import numpy as np
from PIL import Image

ENTITY_POOL = ["head_surgeon", "assistant_surgeon", "patient", "nurse",
               "instrument_table", "operating_table", "drill", "saw"]
PRED_POOL = ["cutting", "sawing", "holding", "closeTo", "preparing"]


def _write_jpg(path: Path, size=(32, 24), seed=0):
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, (size[1], size[0], 3), np.uint8)).save(path)


def _write_pcd(path: Path, n=64, seed=0):
    """Minimal ascii PCD with xyz + rgb fields (open3d-compatible layout)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 2000, (n, 3))  # millimetres, like the real clouds
    colors = rng.uniform(0, 1, (n, 3))
    lines = [
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        "FIELDS x y z rgb",
        "SIZE 4 4 4 4",
        "TYPE F F F F",
        "COUNT 1 1 1 1",
        f"WIDTH {n}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n}",
        "DATA ascii",
    ]
    for p, c in zip(pts, colors):
        rgb = (int(c[0] * 255) << 16) | (int(c[1] * 255) << 8) | int(c[2] * 255)
        packed = struct.unpack("f", struct.pack("I", rgb))[0]
        lines.append(f"{p[0]:.3f} {p[1]:.3f} {p[2]:.3f} {packed:.9g}")
    path.write_text("\n".join(lines))


def _relationships(rng: random.Random, n=2):
    ents = rng.sample(ENTITY_POOL, k=min(len(ENTITY_POOL), n + 1))
    return [
        [ents[i], ents[i + 1], rng.choice(PRED_POOL)]
        for i in range(n)
    ]


def build_synthetic_dataset(
    root: Path,
    n_frames: int = 4,
    mmor_take: str = "001_PKA",
    or4d_take: str = "001_4DOR",
    seed: int = 0,
) -> dict:
    """Create MM-OR_data/, 4D-OR_data/ and data/ trees under ``root``.

    Returns {'mmor_root', 'or4d_root', 'data_path'} for ORDataset.
    """
    rng = random.Random(seed)
    mmor_root = root / "MM-OR_data"
    or4d_root = root / "4D-OR_data"
    data_path = root / "data"
    data_path.mkdir(parents=True, exist_ok=True)

    # ---------------- MM-OR take ----------------
    take_dir = mmor_root / mmor_take
    timestamps = []
    tracks = []
    for f in range(n_frames):
        idx = f"{f:06d}"
        timestamps.append([str(f), {
            "azure": idx, "simstation": idx, "trackercam": idx, "pcd": idx,
        }])
        for c in range(1, 6):
            _write_jpg(take_dir / "colorimage" / f"camera0{c}_colorimage-{idx}.jpg",
                       seed=seed + f * 10 + c)
        for c in range(4):
            _write_jpg(take_dir / "simstation" / f"camera0{c}_{idx}.jpg",
                       seed=seed + f * 20 + c)
        _write_jpg(take_dir / "trackercam" / f"{idx}.jpg", seed=seed + f)
        _write_pcd(mmor_root / "take_point_clouds_sparse" / mmor_take / f"{f}.pcd",
                   seed=seed + f)
        emb_dir = mmor_root / "take_audio_embeddings_per_timepoint" / mmor_take
        emb_dir.mkdir(parents=True, exist_ok=True)
        np.save(emb_dir / f"{f}.pt.npy", np.random.default_rng(seed + f).standard_normal(512, dtype=np.float32))
        (emb_dir / f"{f}.pt").write_bytes((emb_dir / f"{f}.pt.npy").read_bytes())
        (emb_dir / f"{f}.pt.npy").unlink()
        tr_dir = mmor_root / "take_transcripts_per_timepoint" / mmor_take
        tr_dir.mkdir(parents=True, exist_ok=True)
        (tr_dir / f"{f}.json").write_text(json.dumps({"text": f"transcript {f}"}))
        sc_dir = mmor_root / "screen_summaries" / mmor_take
        sc_dir.mkdir(parents=True, exist_ok=True)
        (sc_dir / f"{idx}.json").write_text(json.dumps(
            {"0": {"type": "phase", "template_name": f"phase_{f}"}}
        ))
        tracks.append({"unique_id_dicts": [{
            "unique_id": "8000057", "button_state": 1,
            "Translation": [100 + f, 200, 300], "euler_rot": [0, 90, 0],
        }]})
    (take_dir / f"timestamp_to_pcd_and_frames_list_{mmor_take}.json").write_text(
        json.dumps(timestamps)
    )
    tracks_dir = mmor_root / "take_tracks"
    tracks_dir.mkdir(parents=True, exist_ok=True)
    (tracks_dir / f"{mmor_take}.json").write_text(json.dumps(tracks))

    # ---------------- 4D-OR take ----------------
    or4d_folder = or4d_root / f"export_holistic_take{int(or4d_take.split('_')[0])}_processed"
    timestamps4d = []
    for f in range(n_frames):
        idx = f"{f:06d}"
        timestamps4d.append([str(f), {
            **{f"color_{c}": idx for c in range(1, 7)}, "pcd": idx,
        }])
        for c in range(1, 7):
            _write_jpg(or4d_folder / "colorimage" / f"camera0{c}_colorimage-{idx}.jpg",
                       seed=seed + 100 + f * 10 + c)
        _write_pcd(or4d_folder / "pcds_sparse" / f"{idx}.pcd", seed=seed + 100 + f)
    (or4d_folder / "timestamp_to_pcd_and_frames_list.json").write_text(
        json.dumps(timestamps4d)
    )

    # ---------------- annotations ----------------
    for split, fname in (("train", "relationships_train.json"),
                         ("val", "relationships_validation.json"),
                         ("test", "relationships_test.json")):
        samples = []
        for f in range(n_frames):
            samples.append({
                "take_name": f"{mmor_take}_MMOR",
                "frame_id": str(f),
                "relationships": _relationships(rng),
            })
            samples.append({
                "take_name": or4d_take,
                "frame_id": str(f),
                "relationships": _relationships(rng),
            })
        (data_path / fname).write_text(json.dumps(samples))

    return {"mmor_root": mmor_root, "or4d_root": or4d_root, "data_path": data_path}
