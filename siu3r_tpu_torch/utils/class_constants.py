"""ADE20K / COCO panoptic class tables (public dataset label facts, stored
as JSON; reference src/utils/coco_constant.py). Used by the config binder
for the 2D-pretraining datasets (reference src/config.py:182-193)."""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path

_JSON = Path(__file__).with_name("class_tables.json")


@lru_cache(maxsize=1)
def _tables() -> dict:
    with open(_JSON) as f:
        return json.load(f)


def panoptic_id2name(dataset: str) -> dict[int, str]:
    return {int(k): v for k, v in _tables()[dataset]["panoptic_id2name"].items()}


def stuff_classes(dataset: str) -> list[int]:
    return list(_tables()[dataset]["stuff"])


def thing_classes(dataset: str) -> list[int]:
    return list(_tables()[dataset]["things"])


ADE20K_PANOPTIC_SEMANTIC2NAME = panoptic_id2name("ade20k")
ADE20K_STUFF_CLASSES = stuff_classes("ade20k")
ADE20K_THING_CLASSES = thing_classes("ade20k")
COCO_PANOPTIC_SEMANTIC2NAME = panoptic_id2name("coco")
COCO_STUFF = stuff_classes("coco")
COCO_THINGS = thing_classes("coco")
