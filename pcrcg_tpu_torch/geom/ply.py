"""PLY point-cloud IO (binary little-endian + ascii read, binary write).

The port's copy of ``pcrcg_tpu/geom/ply.py`` (numpy only; reference
lib/ply.py:113,212, read_ply / write_ply used for kernel dispositions and
debug dumps), written against the PLY format spec.  The bytes written equal
the JAX package's.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1",
    "short": "i2", "ushort": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}
_INV_DTYPES = {
    np.dtype("i1"): "char", np.dtype("u1"): "uchar",
    np.dtype("i2"): "short", np.dtype("u2"): "ushort",
    np.dtype("i4"): "int", np.dtype("u4"): "uint",
    np.dtype("f4"): "float", np.dtype("f8"): "double",
    np.dtype("i8"): "int", np.dtype("u8"): "uint",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Returns a dict of per-vertex property arrays (like the reference's
    structured-array access pattern: data['x'], data['y'], ...)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        count = 0
        props: List[Tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().strip().decode("ascii")
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    count = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                props.append((parts[2], _PLY_DTYPES[parts[1]]))

        if fmt == "ascii":
            rows = np.loadtxt(f, max_rows=count, ndmin=2)
            return {name: rows[:, i] for i, (name, _) in enumerate(props)}
        endian = "<" if fmt == "binary_little_endian" else ">"
        dtype = np.dtype([(name, endian + dt) for name, dt in props])
        data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
        return {name: np.array(data[name]) for name, _ in props}


def write_ply(path: str, fields: Sequence[np.ndarray], field_names: Sequence[str]) -> bool:
    """fields: arrays (or one [N,k] array per entry) matching field_names in
    flat order — the reference write_ply call convention
    (kernel_points.py:427: write_ply(file, kernel_points, ['x','y','z']))."""
    cols: List[np.ndarray] = []
    for arr in fields if isinstance(fields, (list, tuple)) else [fields]:
        arr = np.asarray(arr)
        if arr.ndim == 1:
            cols.append(arr)
        else:
            cols.extend(arr[:, i] for i in range(arr.shape[1]))
    assert len(cols) == len(field_names), (len(cols), field_names)
    n = len(cols[0])
    if not path.endswith(".ply"):
        path = path + ".ply"
    def col_dtype(c):
        d = np.dtype(c.dtype)
        if d not in _INV_DTYPES:
            d = np.dtype("f4")
        if d == np.dtype("i8"):
            d = np.dtype("i4")
        if d == np.dtype("u8"):
            d = np.dtype("u4")
        return "<" + d.str[1:]

    dtype = np.dtype([(name, col_dtype(c)) for name, c in zip(field_names, cols)])
    rec = np.empty(n, dtype=dtype)
    for name, c in zip(field_names, cols):
        rec[name] = c.astype(rec.dtype[name])
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for name in field_names:
            ply_t = _INV_DTYPES[np.dtype(rec.dtype[name])]
            f.write(f"property {ply_t} {name}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())
    return True
