"""ScanNet-20 panoptic label tables (standard public ScanNet benchmark
class ids/colors; reference src/utils/scannet_constant.py).

In *model output space* classes are 0-indexed (0=wall .. 19=otherfurniture);
``STUFF_CLASSES`` are the output-space ids to fuse during panoptic
post-processing (wall, floor). Dataset-space panoptic ids are 1-indexed with
0 = unlabeled.
"""

_PANOPTIC_NAMES = [
    "unlabeled", "wall", "floor", "cabinet", "bed", "chair", "sofa", "table",
    "door", "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
]

# dataset-space id -> name, excluding 0/unlabeled (keys 1..20)
PANOPTIC_SEMANTIC2NAME = {i: n for i, n in enumerate(_PANOPTIC_NAMES) if i > 0}
PANOPTIC_NAME2SEMANTIC = {v: k for k, v in PANOPTIC_SEMANTIC2NAME.items()}

STUFF_CLASSES = [0, 1]  # output-space: wall, floor
THING_CLASSES = list(range(2, 20))

PANOPTIC_COLOR_PALLETE = {
    0: [0, 0, 0],
    1: [174, 199, 232],
    2: [152, 223, 138],
    3: [31, 119, 180],
    4: [255, 187, 120],
    5: [188, 189, 34],
    6: [140, 86, 75],
    7: [255, 152, 150],
    8: [214, 39, 40],
    9: [197, 176, 213],
    10: [148, 103, 189],
    11: [196, 156, 148],
    12: [23, 190, 207],
    13: [247, 182, 210],
    14: [219, 219, 141],
    15: [255, 127, 14],
    16: [158, 218, 229],
    17: [44, 160, 44],
    18: [112, 128, 144],
    19: [227, 119, 194],
    20: [82, 84, 163],
}

_INSTANCE_NAMES = [
    "unlabeled", "cabinet", "bed", "chair", "sofa", "table", "door", "window",
    "bookshelf", "picture", "counter", "desk", "curtain", "refrigerator",
    "shower curtain", "toilet", "sink", "bathtub", "otherfurniture",
]
INSTANCE_SEMANTIC2NAME = {i: n for i, n in enumerate(_INSTANCE_NAMES) if i > 0}
INSTANCE_NAME2SEMANTIC = {v: k for k, v in INSTANCE_SEMANTIC2NAME.items()}

INSTANCE_COLOR_PALLETE = {
    0: [0, 0, 0],
    1: [31, 119, 180],
    2: [255, 187, 120],
    3: [188, 189, 34],
    4: [140, 86, 75],
    5: [255, 152, 150],
    6: [214, 39, 40],
    7: [197, 176, 213],
    8: [148, 103, 189],
    9: [196, 156, 148],
    10: [23, 190, 207],
    11: [247, 182, 210],
    12: [219, 219, 141],
    13: [255, 127, 14],
    14: [158, 218, 229],
    15: [44, 160, 44],
    16: [112, 128, 144],
    17: [227, 119, 194],
    18: [82, 84, 163],
}
