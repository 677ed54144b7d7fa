"""Dataset-layout constants: takes, splits, folder maps, tracker objects.

Copy of ``mmor_tpu/data/configurations.py``: the port imports nothing of the JAX
package, so it keeps its own copy of the host code it uses.

Parity with the reference `helpers/configurations.py:1-141` (scene-graph
stack) — the dataset roots default to the reference's relative locations but
are overridable via environment variables MMOR_DATA_ROOT / OR4D_DATA_ROOT.
"""

from __future__ import annotations

import os
from pathlib import Path

OR4D_TAKE_NAMES = tuple(f"{i:03d}_4DOR" for i in range(1, 11))
OR4D_TAKE_NAME_TO_FOLDER = {
    f"{i:03d}_4DOR": f"export_holistic_take{i}_processed" for i in range(1, 11)
}

OR4D_SPLIT_TO_TAKES = {
    "train": ["001_4DOR", "003_4DOR", "005_4DOR", "007_4DOR", "009_4DOR", "010_4DOR"],
    "small_train": ["001_4DOR", "005_4DOR", "007_4DOR", "009_4DOR"],
    "mini_train": ["001_4DOR"],  # debugging fixture
    "val": ["004_4DOR", "008_4DOR"],
    "test": ["002_4DOR", "006_4DOR"],
}

MMOR_TAKE_NAMES = (
    "001_PKA", "002_PKA", "003_TKA", "004_PKA", "005_TKA", "006_PKA", "007_TKA",
    "008_PKA", "009_TKA", "010_PKA", "011_TKA", "012_1_PKA", "012_2_PKA",
    "013_PKA", "014_PKA", "015_PKA", "016_PKA", "017_PKA", "018_1_PKA",
    "018_2_PKA", "019_PKA", "020_PKA", "021_PKA", "022_PKA", "023_PKA",
    "024_PKA", "025_PKA", "026_PKA", "027_PKA", "028_PKA", "029_PKA",
    "030_PKA", "031_PKA", "032_PKA", "033_PKA", "035_PKA", "036_PKA",
    "037_TKA", "038_TKA",
)

# combined recordings: several logical takes share one folder
MMOR_TAKE_NAME_TO_FOLDER = {
    "012_1_PKA": "012_PKA", "012_2_PKA": "012_PKA",
    **{f"{i:03d}_PKA": "015-018_PKA" for i in (15, 16, 17)},
    "018_1_PKA": "015-018_PKA", "018_2_PKA": "015-018_PKA",
    **{f"{i:03d}_PKA": "019-022_PKA" for i in range(19, 23)},
    **{f"{i:03d}_PKA": "023-032_PKA" for i in range(23, 33)},
}

MMOR_SPLIT_TO_TAKES = {
    "train": ["001_PKA", "003_TKA", "005_TKA", "006_PKA", "008_PKA", "010_PKA",
              "012_1_PKA", "012_2_PKA", "035_PKA", "037_TKA"],
    "small_train": ["001_PKA", "003_TKA", "035_PKA", "037_TKA", "005_TKA"],
    "mini_train": ["013_PKA"],  # debugging fixture
    "val": ["002_PKA", "007_TKA", "009_TKA"],
    "test": ["004_PKA", "011_TKA", "036_PKA", "038_TKA"],
    "short_clips": ["013_PKA", "014_PKA", "015_PKA", "016_PKA", "017_PKA",
                    "018_1_PKA", "018_2_PKA", "019_PKA", "020_PKA", "021_PKA",
                    "022_PKA", "023_PKA", "024_PKA", "025_PKA", "026_PKA",
                    "027_PKA", "028_PKA", "029_PKA", "030_PKA", "031_PKA",
                    "032_PKA", "033_PKA"],
}

TRACKER_OBJECT_MAP = {
    "8000050": "base_array",
    "8000056": "calibration_array",
    "8000057": "upper_tracker",
    "8000058": "lower_tracker",
    "8000054": "green_tip",
    "8000053": "blue_tip",
    "8000999": "calibration_array",
}

# human-pose limb topology (keypoint index pairs)
LIMBS = (
    (5, 4), (9, 7), (7, 3), (2, 6), (6, 8), (5, 3), (4, 2), (3, 1), (2, 1),
    (1, 0), (10, 4), (11, 5), (12, 10), (13, 11),
)

IDX_TO_BODY_PART = (
    "head", "neck", "leftshoulder", "rightshoulder", "lefthip", "righthip",
    "leftelbow", "rightelbow", "leftwrist", "rightwrist", "leftknee",
    "rightknee", "leftfoot", "rightfoot",
)

STATIONARY_OBJECTS = ("instrument_table", "secondary_table")

DEPTH_SCALING = 2000


def mmor_data_root() -> Path:
    return Path(os.environ.get("MMOR_DATA_ROOT", "../MM-OR_data"))


def or4d_data_root() -> Path:
    return Path(os.environ.get("OR4D_DATA_ROOT", "../4D-OR_data"))
