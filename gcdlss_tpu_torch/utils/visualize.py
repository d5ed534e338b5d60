"""Point-cloud visualization: label colorization + PLY read/write.

Copy of `gcdlss_tpu/utils/visualize.py` (numpy alone), the reference's
`utils/visualize.py` (label -> RGB through the dataset colour map) and the
PLY serialization of `utils/visualize_ply.py` / `ply_vis.py` (binary
little-endian PLY, one vertex element). Used by the Stage-2 module's test
dump (`--visualize`, `exp_merge_mean_teacher.py:2630-2637`).
"""

from __future__ import annotations

import numpy as np

from ..data.meta import dataset_meta

_PLY_DTYPES = {
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}
_NP_TO_PLY = {
    np.dtype("int8"): "char", np.dtype("uint8"): "uchar",
    np.dtype("int16"): "short", np.dtype("uint16"): "ushort",
    np.dtype("int32"): "int", np.dtype("uint32"): "uint",
    np.dtype("float32"): "float", np.dtype("float64"): "double",
}


def get_color(labels: np.ndarray, dataset: str = "SemanticKITTI") -> np.ndarray:
    """Map train-label ids to RGB uint8 via learning_map_inv + color_map."""
    meta = dataset_meta(dataset)
    inv = meta["learning_map_inv"]
    cmap = meta["color_map"]
    out = np.zeros((labels.shape[0], 3), np.uint8)
    for train_id, raw_id in inv.items():
        bgr = cmap.get(raw_id, [0, 0, 0])
        out[labels == train_id] = bgr[::-1]  # stored BGR -> RGB
    return out


def write_ply(filename: str, field_list, field_names):
    """Write a binary PLY. `field_list` is a list of [N, k] arrays whose
    concatenated columns match `field_names`."""
    if not filename.endswith(".ply"):
        filename += ".ply"
    fields = [np.atleast_2d(f) if f.ndim == 1 else f for f in field_list]
    fields = [f.T if f.shape[0] == 1 and f.shape[1] > 1 else f for f in fields]
    fields = [f.reshape(-1, 1) if f.ndim == 1 else f for f in fields]
    n = fields[0].shape[0]
    cols = []
    for f in fields:
        for j in range(f.shape[1]):
            cols.append(f[:, j])
    assert len(cols) == len(field_names)
    with open(filename, "wb") as fh:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}"]
        for name, col in zip(field_names, cols):
            header.append(f"property {_NP_TO_PLY[col.dtype]} {name}")
        header.append("end_header\n")
        fh.write(("\n".join(header)).encode("ascii"))
        rec = np.rec.fromarrays(
            cols, names=",".join(field_names)
        )
        rec.tofile(fh)
    return True


def read_ply(filename: str):
    """Read a binary little-endian PLY written by write_ply; returns a
    structured numpy array."""
    with open(filename, "rb") as fh:
        line = b""
        props = []
        n = 0
        while b"end_header" not in line:
            line = fh.readline()
            tok = line.decode("ascii", "ignore").split()
            if not tok:
                continue
            if tok[0] == "element" and tok[1] == "vertex":
                n = int(tok[2])
            elif tok[0] == "property":
                ply_t, name = tok[1], tok[2]
                np_t = {v: k for k, v in _NP_TO_PLY.items()}[ply_t]
                props.append((name, np_t))
        data = np.fromfile(fh, dtype=props, count=n)
    return data
