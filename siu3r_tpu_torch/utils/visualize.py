"""Visualisation helpers, counterpart of ``siu3r_tpu/utils/visualize.py``
(reference src/utils/visualize_utils.py subset and the depth colour maps the
Visualizer writes). numpy and PIL on the host, next to the PNG writes.

The labeled overlays draw each region without OpenCV: its contour is the
region's boundary (the mask minus its 4-neighbour erosion), its box the
mask's extents, both widened by one pixel to each side as OpenCV's
2-thick lines are, and its tag's text is drawn with PIL's default font. The
JAX package draws them with ``cv2``: the boxes are the same pixels; contours
differ within a 3-pixel band of the boundary, and tags within their
rectangles (another font).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from siu3r_tpu_torch.utils.scannet_constant import (
    INSTANCE_COLOR_PALLETE,
    PANOPTIC_COLOR_PALLETE,
    PANOPTIC_SEMANTIC2NAME,
)

# perceptually ordered turbo-like stops for depth colorization
_TURBO_STOPS = np.array(
    [
        [48, 18, 59], [70, 107, 227], [40, 187, 235], [31, 233, 162],
        [127, 252, 65], [218, 220, 34], [253, 141, 12], [210, 51, 0],
        [122, 4, 3],
    ],
    np.float32,
)


def colorize_depth(
    depth: np.ndarray, d_min: Optional[float] = None, d_max: Optional[float] = None
) -> np.ndarray:
    """[H, W] metric depth -> [H, W, 3] uint8 turbo-style colormap; invalid
    (<=0) pixels black."""
    valid = depth > 0
    if d_min is None:
        d_min = float(depth[valid].min()) if valid.any() else 0.0
    if d_max is None:
        d_max = float(depth[valid].max()) if valid.any() else 1.0
    t = np.clip((depth - d_min) / max(d_max - d_min, 1e-6), 0, 1)
    pos = t * (len(_TURBO_STOPS) - 1)
    i0 = np.clip(np.floor(pos).astype(int), 0, len(_TURBO_STOPS) - 2)
    frac = (pos - i0)[..., None]
    rgb = _TURBO_STOPS[i0] * (1 - frac) + _TURBO_STOPS[i0 + 1] * frac
    rgb = np.where(valid[..., None], rgb, 0)
    return rgb.astype(np.uint8)


def _palette(max_id: int, table: Dict[int, list], seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    pal = rng.randint(30, 255, (max_id + 1, 3)).astype(np.uint8)
    for k, v in table.items():
        if k <= max_id:
            pal[k] = v
    pal[0] = 0
    return pal


def semantic_to_rgb(sem: np.ndarray) -> np.ndarray:
    """[H, W] semantic ids (0 background, 1..20 ScanNet) -> RGB uint8."""
    pal = _palette(max(20, int(sem.max(initial=0))), PANOPTIC_COLOR_PALLETE)
    return pal[np.clip(sem, 0, len(pal) - 1)]


def instance_to_rgb(ins: np.ndarray, seed: int = 0) -> np.ndarray:
    """[H, W] instance ids -> distinct random colors (0 = black)."""
    pal = _palette(max(32, int(ins.max(initial=0))), INSTANCE_COLOR_PALLETE, seed)
    return pal[np.clip(ins, 0, len(pal) - 1)]


def overlay_segmentation(
    image: np.ndarray, sem: np.ndarray, ins: Optional[np.ndarray] = None,
    alpha: float = 0.5,
) -> np.ndarray:
    """Blend a segmentation over an RGB image (alpha from VisualizerCfg).
    image [H, W, 3] in [0, 1] or uint8."""
    img = image if image.dtype == np.uint8 else (np.clip(image, 0, 1) * 255).astype(np.uint8)
    seg_rgb = instance_to_rgb(ins) if ins is not None else semantic_to_rgb(sem)
    mask = (sem > 0)[..., None]
    blended = img * (1 - alpha) + seg_rgb * alpha
    return np.where(mask, blended, img).astype(np.uint8)


# standard jet stops (reference uses kornia jet, visualizer.py:294)
_JET_STOPS = np.array(
    [[0, 0, 131], [0, 0, 255], [0, 255, 255], [255, 255, 0], [255, 0, 0],
     [128, 0, 0]],
    np.float32,
)


def _apply_jet(t: np.ndarray) -> np.ndarray:
    """t in [0,1] [H, W] -> jet RGB uint8."""
    t = np.clip(np.nan_to_num(t), 0.0, 1.0)
    pos = t * (len(_JET_STOPS) - 1)
    i0 = np.clip(np.floor(pos).astype(int), 0, len(_JET_STOPS) - 2)
    frac = (pos - i0)[..., None]
    rgb = _JET_STOPS[i0] * (1 - frac) + _JET_STOPS[i0 + 1] * frac
    return rgb.astype(np.uint8)


def colorize_depth_jet(depth: np.ndarray, log_scale: bool = True) -> np.ndarray:
    """Jet-colormap depth grid matching the reference visualizer
    (visualizer.py:293-330): rendered depth uses inverted log-scale
    normalization between the 1%/99% quantiles; GT depth uses min-max."""
    d = np.asarray(depth, np.float64)
    if log_scale:
        pos = d[d > 0]
        if pos.size == 0:
            return np.zeros(d.shape + (3,), np.uint8)
        # q01 over positive depths, q99 over all values (reference :295-303)
        lo = np.log(max(np.quantile(pos, 0.01), 1e-9))
        hi = np.log(max(np.quantile(d.reshape(-1), 0.99), 1e-9))
        t = 1.0 - (np.log(np.maximum(d, 1e-9)) - lo) / max(hi - lo, 1e-9)
    else:
        lo, hi = float(d.min()), float(d.max())
        t = (d - lo) / max(hi - lo, 1e-9)
    return _apply_jet(t)


def _cross(mask: np.ndarray) -> np.ndarray:
    """``mask`` with its 4-neighbours: the pixels within distance 1."""
    p = np.pad(mask, 1)
    return mask | p[:-2, 1:-1] | p[2:, 1:-1] | p[1:-1, :-2] | p[1:-1, 2:]


def _boundary(region: np.ndarray) -> np.ndarray:
    """The region's pixels with a 4-neighbour outside it (the image's edge
    counts as outside)."""
    p = np.pad(region, 1)
    eroded = region & p[:-2, 1:-1] & p[2:, 1:-1] & p[1:-1, :-2] & p[1:-1, 2:]
    return region & ~eroded


def _box_outline(h: int, w: int, x0: int, y0: int, x1: int, y1: int) -> np.ndarray:
    """The rectangle (x0, y0)-(x1, y1) as OpenCV draws it 2 thick: its
    one-pixel outline widened to the pixels within distance 1, on [h, w]."""
    line = np.zeros((h + 2, w + 2), bool)  # one pixel of margin: x1, y1 may lie just past the image
    line[y0 + 1, x0 + 1:x1 + 2] = line[y1 + 1, x0 + 1:x1 + 2] = True
    line[y0 + 1:y1 + 2, x0 + 1] = line[y0 + 1:y1 + 2, x1 + 1] = True
    return _cross(line)[1:-1, 1:-1]


def _font():
    from PIL import ImageFont

    return ImageFont.load_default()


def tag_box(text: str, box: Tuple[int, int, int, int]) -> Tuple[int, int, int, int]:
    """The filled rectangle (left, top, right, bottom, inclusive) behind a
    region's tag: the text's size centred in ``box`` = (x0, y0, x1, y1), 3
    pixels of margin on the sides and 2 above and below, as the JAX package
    places its OpenCV text."""
    left, top, right, bottom = _font().getbbox(text)
    tw, th = right - left, bottom - top
    x0, y0, x1, y1 = box
    tx = x0 + (x1 - x0 - tw) // 2
    ty = y0 + (y1 - y0 + th) // 2
    return tx - 3, ty - th - 2, tx + tw + 3, ty + 2


def _draw_labeled_region(canvas: np.ndarray, region: np.ndarray, color, text: str) -> None:
    """Box, white contour and a tag "text" on a filled rectangle of ``color``
    for one segment onto ``canvas`` (uint8 [H, W, 3], already mask-filled):
    the labeled-overlay primitive of reference visualizer.py:556-712."""
    from PIL import Image, ImageDraw

    if not region.any():
        return
    h, w = region.shape
    ys, xs = np.nonzero(region)
    x0, y0, x1, y1 = int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1
    color = tuple(int(v) for v in color)
    canvas[_box_outline(h, w, x0, y0, x1, y1)] = color
    canvas[_cross(_boundary(region))] = (255, 255, 255)
    font = _font()
    left, top, right, bottom = font.getbbox(text)
    rect = tag_box(text, (x0, y0, x1, y1))
    im = Image.fromarray(canvas)
    draw = ImageDraw.Draw(im)
    draw.rectangle(rect, fill=color)
    # the text's box from (left + 3, bottom - 2) of the rectangle, as OpenCV's baseline
    draw.text((rect[0] + 3 - left, rect[3] - 2 - bottom), text, fill=(0, 0, 0), font=font)
    canvas[...] = np.asarray(im)


def _as_uint8(images: np.ndarray) -> np.ndarray:
    return images if images.dtype == np.uint8 else (np.clip(images, 0, 1) * 255).astype(np.uint8)


def _blend(imgs: np.ndarray, panels: list, alpha: float) -> np.ndarray:
    colored = np.concatenate(panels, axis=1)  # [H, N*W, 3]
    out = np.concatenate(list(imgs), axis=1).copy()
    sel = colored != 0
    out[sel] = (alpha * colored[sel] + (1 - alpha) * out[sel]).astype(np.uint8)
    return out


def labeled_instance_overlay(
    images: np.ndarray,  # [N, H, W, 3] in [0,1] or uint8
    seg: np.ndarray,  # [N, H, W] segment ids (0/-1 = background)
    segments_info,  # [{"id", "label_id", "score"}] — post-process output
    alpha: float = 0.5,
) -> np.ndarray:
    """Labeled prediction overlay: per-segment color fill + white contours +
    bounding box + "id|name|score" tag, views concatenated along width
    (reference draw_overlay_segm_masks, visualizer.py:556-660). label_id is
    the model output class (0-based); dataset semantic id = label_id + 1."""
    imgs = _as_uint8(images)
    n, h, w, _ = imgs.shape
    panels = []
    for vi in range(n):
        canvas = np.zeros((h, w, 3), np.uint8)
        for info in segments_info:
            sem = int(info["label_id"]) + 1
            canvas[seg[vi] == info["id"]] = PANOPTIC_COLOR_PALLETE.get(sem, [200, 200, 200])
        for info in segments_info:
            sem = int(info["label_id"]) + 1
            color = PANOPTIC_COLOR_PALLETE.get(sem, [200, 200, 200])
            name = PANOPTIC_SEMANTIC2NAME.get(sem, str(sem))
            tag = f"{info['id']}|{name}|{info.get('score', 0.0):.2f}"
            _draw_labeled_region(canvas, seg[vi] == info["id"], color, tag)
        panels.append(canvas)
    return _blend(imgs, panels, alpha)


def labeled_gt_overlay(
    images: np.ndarray,  # [N, H, W, 3]
    mask_labels: np.ndarray,  # [O, N, H, W] binary per-object masks
    class_labels: np.ndarray,  # [O] model-space class ids
    valid: np.ndarray = None,  # [O] bool
    alpha: float = 0.5,
) -> np.ndarray:
    """GT-label twin of labeled_instance_overlay (reference
    visualizer.py:661-712): class-name tags only."""
    imgs = _as_uint8(images)
    o, n, h, w = mask_labels.shape
    panels = []
    for vi in range(n):
        canvas = np.zeros((h, w, 3), np.uint8)
        for k in range(o):
            if valid is not None and not valid[k]:
                continue
            sem = int(class_labels[k]) + 1
            color = PANOPTIC_COLOR_PALLETE.get(sem, [200, 200, 200])
            region = mask_labels[k, vi] > 0.5
            canvas[region] = color
            _draw_labeled_region(canvas, region, color, PANOPTIC_SEMANTIC2NAME.get(sem, str(sem)))
        panels.append(canvas)
    return _blend(imgs, panels, alpha)
