"""CoNeRF annotations (twin of `freegaussian_tpu/data/conerf_annotations.py`):
polygon / COCO / blender masks and per-frame attribute values.

Hand-annotated key frames carry M articulated-attribute regions; polygons are
rasterized into (H, W, M+1) boolean masks (channel 0 = background = no
annotation), and `values.json` / `values.yaml` map frame ids to per-attribute
scalar states (ref: freegaussian_dataparser.py:156-286).

The JAX package fills polygons with `cv2.fillPoly`; the port has its own
scanline fill with cv2's rules (`fill_polygon`), so it needs no OpenCV.
"""

from __future__ import annotations

import json
import math
from fractions import Fraction
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

def _clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """cv2.clipLine: clip the segment to [0, width) x [0, height); returns
    (inside, x1, y1, x2, y2), the ends moved (in integers) as far as the
    clip got."""
    right, bottom = width - 1, height - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _draw_line(canvas: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> None:
    """cv2's 8-connected line (LineIterator, left to right, clipped to the
    canvas), set to 1."""
    h, w = canvas.shape
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    step_y = 1 if y2 >= y1 else -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        canvas[y, x] = 1
        minor = err < 0  # the minor axis steps
        err += 2 * dx - 2 * dy if minor else -2 * dy
        if vert:
            x += minor
            y += step_y
        else:
            x += 1
            y += step_y if minor else 0


def fill_polygon(canvas: np.ndarray, verts: np.ndarray) -> None:
    """Set the pixels of the polygon `verts` ((K, 2) int xy) in the uint8
    `canvas` to 1 by `cv2.fillPoly(canvas, [verts], 1)`'s rules (LINE_8,
    shift 0), as OpenCV 5.0 gives them:
      - the outline is drawn as 8-connected lines, so edge pixels are in;
      - the interior is an even-odd scanline fill: on each row, the pixels
        whose centres lie between the two edges of a pair, both ends
        included, in exact rational arithmetic; this handles non-convex and
        self-intersecting polygons;
      - an edge with an end outside the canvas runs through its clipped
        (integer) ends over its whole row range, and one clipped to a single
        row stands vertical at its clipped upper end;
      - a polygon wholly outside the canvas draws nothing but the outline."""
    h, w = canvas.shape
    pts = [(int(x), int(y)) for x, y in np.asarray(verts).reshape(-1, 2)]
    edges = []  # (first row, last row + 1, x on the first row, dx per row)
    p0 = pts[-1]
    for p1 in pts:
        _draw_line(canvas, *p0, *p1)
        if p0[1] != p1[1]:
            c0, c1 = p0, p1
            if not (0 <= p0[0] < w and 0 <= p1[0] < w and 0 <= p0[1] < h and 0 <= p1[1] < h):
                _, ax, ay, bx, by = _clip_line(w, h, *p0, *p1)
                c0, c1 = (ax, ay), (bx, by)
            dx = Fraction(c1[0] - c0[0], c1[1] - c0[1]) if c1[1] != c0[1] else Fraction(0)
            (ya, yb), top = sorted((p0[1], p1[1])), (c0 if p0[1] < p1[1] else c1)
            edges.append((ya, yb, top[0] + (ya - top[1]) * dx, dx))
        p0 = p1
    if len(edges) < 2:
        return
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    if max(e[1] for e in edges) < 0 or min(e[0] for e in edges) >= h or max(xs) < 0 or min(xs) >= w:
        return
    for y in range(max(min(e[0] for e in edges), 0), min(max(e[1] for e in edges), h)):
        cross = sorted(x0 + (y - y0) * dx for y0, y1, x0, dx in edges if y0 <= y < y1)
        for left, right in zip(cross[0::2], cross[1::2]):
            x1, x2 = max(math.ceil(left), 0), min(math.floor(right), w - 1)
            if x1 <= x2:
                canvas[y, x1 : x2 + 1] = 1


def rasterize_polygons(
    polygons: List[Tuple[int, np.ndarray]],
    height: int,
    width: int,
    num_attributes: int,
) -> np.ndarray:
    """polygons: list of (attribute_index, (K, 2) xy vertices).
    Returns (H, W, M+1) bool; channel 0 is 'unannotated'."""
    masks = np.zeros((height, width, num_attributes + 1), bool)
    for attr, verts in polygons:
        canvas = np.zeros((height, width), np.uint8)
        pts = np.round(np.asarray(verts, np.float64)).astype(np.int32).reshape(-1, 2)
        fill_polygon(canvas, pts)
        masks[..., attr + 1] |= canvas.astype(bool)
    masks[..., 0] = ~masks[..., 1:].any(-1)
    return masks


def load_conerf_annotation(
    path: Path, height: int, width: int, num_attributes: int, downscale: int = 1
) -> Optional[np.ndarray]:
    """CoNeRF `annotations/{fid}.json`: {"polygons": [{"attribute": i,
    "points"|"vertices": [[x, y], ...]}, ...]} (labelme-style layouts also
    accepted via "shapes"). Coordinates are divided by `downscale` to match
    the rgb/{d}x pyramid level."""
    path = Path(path)
    if not path.exists():
        return None
    tree = json.loads(path.read_text())
    polys = []
    for entry in tree.get("polygons") or tree.get("shapes") or []:
        attr = int(entry.get("attribute", entry.get("label", 0)))
        pts = entry.get("points") or entry.get("vertices") or []
        if len(pts) >= 3:
            polys.append((attr, np.asarray(pts, np.float64) / downscale))
    return rasterize_polygons(polys, height, width, num_attributes)


def load_coco_annotations(
    path: Path, height: int, width: int, num_attributes: int, downscale: int = 1
) -> Dict[str, np.ndarray]:
    """COCO-format annotations: returns {image_stem: (H, W, M+1) bool}.
    Category ids (1-based) map to attribute indices (0-based)."""
    tree = json.loads(Path(path).read_text())
    images = {img["id"]: Path(img["file_name"]).stem for img in tree.get("images", [])}
    out: Dict[str, List] = {}
    for ann in tree.get("annotations", []):
        stem = images.get(ann["image_id"])
        if stem is None:
            continue
        seg = ann.get("segmentation", [])
        attr = int(ann.get("category_id", 1)) - 1
        for poly in seg if isinstance(seg, list) else []:
            pts = np.asarray(poly, np.float64).reshape(-1, 2) / downscale
            out.setdefault(stem, []).append((attr, pts))
    return {stem: rasterize_polygons(polys, height, width, num_attributes) for stem, polys in out.items()}


def coco_num_attributes(path: Path) -> int:
    """Number of articulated attributes in a COCO annotation file: the max
    category id (1-based categories map to 0-based attributes)."""
    tree = json.loads(Path(path).read_text())
    cats = [int(c["id"]) for c in tree.get("categories", [])]
    if not cats:
        cats = [int(a.get("category_id", 1)) for a in tree.get("annotations", [])]
    return max(cats, default=0)


def load_conerf_values(path: Path) -> Dict[str, np.ndarray]:
    """Per-frame scalar attribute states (`annotations/values.json` or
    `values.json`: {fid: [v_0 .. v_{M-1}]}, ref :268-286)."""
    tree = json.loads(Path(path).read_text())
    return {str(k): np.asarray(v, np.float32) for k, v in tree.items()}


def discover_num_attributes(data_dir: Path) -> int:
    """Infer M from values.json or the max attribute index in annotations."""
    data_dir = Path(data_dir)
    for cand in (data_dir / "annotations" / "values.json", data_dir / "values.json"):
        if cand.exists():
            vals = load_conerf_values(cand)
            return max((len(v) for v in vals.values()), default=0)
    best = 0
    ann_dir = data_dir / "annotations"
    for p in sorted(ann_dir.glob("*.json")) if ann_dir.exists() else []:
        tree = json.loads(p.read_text())
        for entry in tree.get("polygons", []) or tree.get("shapes", []) or []:
            best = max(best, int(entry.get("attribute", 0)) + 1)
    return best


def load_blender_annotations(
    ann_dir: Path, fids, height: int, width: int, num_attributes: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Blender-exported `{fid}_segmentation.npy` masks -> (N, H, W, M+1) bool
    stacks + (N, 1) validity, mirroring the reference loader
    (freegaussian_dataparser.py:241-265): channel layout [attrs..., background],
    background = pixels with no attribute."""
    atrb_masks, mask_valids = [], []
    for fid in fids:
        labels = np.zeros((height, width, num_attributes + 1), np.bool_)
        seg_path = Path(ann_dir) / f"{fid}_segmentation.npy"
        if not seg_path.exists() or num_attributes == 0:
            valids = np.zeros(1, np.bool_)
        else:
            seg = np.load(seg_path)
            labels[..., :num_attributes] = seg[..., :num_attributes]
            labels[labels.sum(axis=-1) == 0, -1] = True
            valids = np.ones(1, np.bool_)
        atrb_masks.append(labels)
        mask_valids.append(valids)
    return np.stack(atrb_masks), np.stack(mask_valids)


def load_conerf_values_yaml(
    path: Path, fids, num_attributes: int, norm_vals: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference-format per-frame attribute states: a YAML list of
    {frame, class, value} entries (freegaussian_dataparser.py:268-286).
    Returns (atrb_vals (N, M+1), atrb_val_masks (N, M+1)); values mapped
    0.5*(v+1) like the reference, column 0 reserved for background."""
    import yaml

    entries = yaml.safe_load(Path(path).read_text()) or []
    fid_to_row = {int(fid): i for i, fid in enumerate(fids)}
    vals = np.zeros((len(fids), num_attributes), np.float32)
    val_masks = np.zeros((len(fids), num_attributes + 1), np.float32)
    val_masks[..., -1] = True
    for entry in entries:
        fid, cls = int(entry["frame"]), int(entry["class"])
        if fid in fid_to_row:
            vals[fid_to_row[fid]][cls] = float(entry["value"])
            val_masks[fid_to_row[fid]][cls] = True
    vals = 0.5 * (vals + 1)
    vals = np.hstack([np.zeros((vals.shape[0], 1), np.float32), vals])
    return vals, val_masks
