"""PLY export/import for Gaussian scenes.

Field-for-field parity with the reference writer (reference:
src/utils/ply_export.py:12-97): attributes are
``x y z nx ny nz f_dc_{0..2} [f_rest_*] opacity scale_{0..2} rot_{0..3}
semantic_label instance_label seg_query_class_logits_{q*c}``, where scales are
stored as logs, rotations as wxyz, and normals as zeros. No third-party
``plyfile`` dependency — the format is plain binary_little_endian 1.0.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def _as_numpy(x) -> np.ndarray:
    return np.asarray(x)


def construct_list_of_attributes(num_rest: int) -> list[str]:
    """Reference src/utils/ply_export.py:12-25."""
    attributes = ["x", "y", "z", "nx", "ny", "nz"]
    for i in range(3):
        attributes.append(f"f_dc_{i}")
    for i in range(num_rest):
        attributes.append(f"f_rest_{i}")
    attributes.append("opacity")
    for i in range(3):
        attributes.append(f"scale_{i}")
    for i in range(4):
        attributes.append(f"rot_{i}")
    attributes.append("semantic_label")
    attributes.append("instance_label")
    return attributes


def export_ply(
    means,
    scales,
    rotations,
    harmonics,
    opacities,
    semantic_labels=None,
    instance_labels=None,
    seg_query_class_logits=None,
    path: Path | str = "output.ply",
    shift_and_scale: bool = False,
    save_sh_dc_only: bool = True,
) -> None:
    """Write one scene's Gaussians to a .ply file.

    Args mirror reference export_ply (src/utils/ply_export.py:28-97):
      means [G,3], scales [G,3] (linear; stored as log), rotations [G,4]
      xyzw (stored wxyz), harmonics [G,3,d_sh], opacities [G],
      semantic/instance labels [G] int, seg_query_class_logits [G,Q,C].
    """
    path = Path(path)
    means = _as_numpy(means).astype(np.float32)
    scales = _as_numpy(scales).astype(np.float32)
    rotations = _as_numpy(rotations).astype(np.float32)
    harmonics = _as_numpy(harmonics).astype(np.float32)
    opacities = _as_numpy(opacities).astype(np.float32)

    if shift_and_scale:
        means = means - np.median(means, axis=0)
        scale_factor = np.quantile(np.abs(means), 0.95, axis=0).max()
        means = means / scale_factor
        scales = scales / scale_factor

    x, y, z, w = rotations.T
    rotations_wxyz = np.stack((w, x, y, z), axis=-1)

    f_dc = harmonics[..., 0]
    f_rest = harmonics[..., 1:].reshape(harmonics.shape[0], -1)

    num_rest = 0 if save_sh_dc_only else f_rest.shape[1]
    attrs = construct_list_of_attributes(num_rest)
    dtype_full: list[tuple[str, str]] = [(a, "f4") for a in attrs[:-2]]
    has_labels = semantic_labels is not None and instance_labels is not None
    if has_labels:
        dtype_full.append(("semantic_label", "i4"))
        dtype_full.append(("instance_label", "i4"))
    else:
        # keep parity with reference: attribute names always listed, but the
        # reference also only appends the dtypes when labels are provided.
        dtype_full = [(a, "f4") for a in attrs[:-2]]
    qc_flat = None
    if seg_query_class_logits is not None:
        qc = _as_numpy(seg_query_class_logits).astype(np.float32)
        g, q, c = qc.shape
        qc_flat = qc.reshape(g, q * c)
        for i in range(q * c):
            dtype_full.append((f"seg_query_class_logits_{i}", "f4"))

    n = means.shape[0]
    elements = np.empty(n, dtype=dtype_full)
    columns = [
        means,
        np.zeros_like(means),
        f_dc,
    ]
    if not save_sh_dc_only:
        columns.append(f_rest)
    columns.append(opacities[:, None])
    columns.append(np.log(scales))
    columns.append(rotations_wxyz)
    float_block = np.concatenate(columns, axis=1).astype("<f4")
    names = [d[0] for d in dtype_full]
    n_float = float_block.shape[1]
    for i in range(n_float):
        elements[names[i]] = float_block[:, i]
    cursor = n_float
    if has_labels:
        elements["semantic_label"] = _as_numpy(semantic_labels).astype("<i4")
        elements["instance_label"] = _as_numpy(instance_labels).astype("<i4")
        cursor += 2
    if qc_flat is not None:
        for i in range(qc_flat.shape[1]):
            elements[names[cursor + i]] = qc_flat[:, i].astype("<f4")

    path.parent.mkdir(exist_ok=True, parents=True)
    _write_binary_ply(path, elements)


_PLY_TYPE = {"f4": "float", "i4": "int", "u1": "uchar", "f8": "double"}
_NP_TYPE = {v: k for k, v in _PLY_TYPE.items()}


def _write_binary_ply(path: Path, elements: np.ndarray) -> None:
    header_lines = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {elements.shape[0]}",
    ]
    for name in elements.dtype.names:
        kind = elements.dtype[name].str.lstrip("<>|=")
        header_lines.append(f"property {_PLY_TYPE[kind]} {name}")
    header_lines.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header_lines) + "\n").encode("ascii"))
        # ensure little-endian packed layout
        packed = np.empty(
            elements.shape[0],
            dtype=[(n, elements.dtype[n].str.replace(">", "<")) for n in elements.dtype.names],
        )
        for n in elements.dtype.names:
            packed[n] = elements[n]
        f.write(packed.tobytes())


def read_ply(path: Path | str) -> dict[str, np.ndarray]:
    """Read a vertex-element PLY (binary little-endian or ascii) into a dict of
    per-property arrays. Used by the viewer and round-trip tests."""
    path = Path(path)
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = None
        count = 0
        props: list[tuple[str, str]] = []
        for line in header:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element" and tok[1] == "vertex":
                count = int(tok[2])
            elif tok[0] == "property" and len(tok) == 3:
                props.append((tok[2], _NP_TYPE[tok[1]]))
        dtype = np.dtype([(name, "<" + kind) for name, kind in props])
        if fmt == "binary_little_endian":
            data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
        elif fmt == "ascii":
            rows = [f.readline().decode("ascii").split() for _ in range(count)]
            data = np.array([tuple(r) for r in rows], dtype=dtype)
        else:
            raise ValueError(f"unsupported ply format {fmt}")
    return {name: np.ascontiguousarray(data[name]) for name, _ in props}
