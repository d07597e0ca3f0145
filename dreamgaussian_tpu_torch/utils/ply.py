"""Self-contained PLY reader/writer for gaussian clouds and triangle meshes.

The port's copy of the binary path of ``dreamgaussian_tpu/utils/ply.py``:
for gaussians a single ``vertex`` element of float32 properties
x,y,z,nx,ny,nz,f_dc_*,f_rest_*,opacity,scale_*,rot_*; for meshes a
``vertex`` element and a ``face`` element of triangle index lists. Output
is byte-identical to the JAX package's writer.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_DTYPES = {"f4": "float", "f8": "double", "i4": "int", "u4": "uint",
               "i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort"}


def write_ply(path: str, elements: Mapping[str, np.ndarray]) -> None:
    """Write elements {name: structured array} as binary little-endian PLY."""
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0"]
        for name, arr in elements.items():
            assert arr.dtype.names, f"element {name} must be a structured array"
            header.append(f"element {name} {len(arr)}")
            for prop in arr.dtype.names:
                header.append(f"property {_INV_DTYPES[arr.dtype[prop].str[1:]]} {prop}")
        header.append("end_header")
        f.write(("\n".join(header) + "\n").encode("ascii"))
        for arr in elements.values():
            f.write(arr.astype(arr.dtype.newbyteorder("<")).tobytes())


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read a binary little-endian PLY -> {element name: structured numpy
    array}. An element that is one list property of fixed arity (triangle
    faces) comes back as an int32 [F, K] array under ``<element>_indices``."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"not a PLY file: {path}")
    header_end = data.find(b"\n", header_end) + 1
    fmt = None
    elements: list[tuple[str, int, list]] = []
    for line in data[:header_end].decode("ascii", errors="replace").splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], ("list", _PLY_DTYPES[parts[2]],
                                                   _PLY_DTYPES[parts[3]])))
            else:
                elements[-1][2].append((parts[2], _PLY_DTYPES[parts[1]]))
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format: {fmt}")
    body = data[header_end:]
    out: dict[str, np.ndarray] = {}
    offset = 0
    for name, count, props in elements:
        if any(isinstance(t, tuple) for _, t in props):
            if len(props) != 1:
                raise ValueError("an element mixing list and scalar properties is not supported")
            _, (_, cnt_t, idx_t) = props[0]
            arity = int(np.frombuffer(body, "<" + cnt_t, 1, offset)[0]) if count else 3
            row = np.dtype([("n", "<" + cnt_t), ("idx", "<" + idx_t, (arity,))])
            rows = np.frombuffer(body, dtype=row, count=count, offset=offset)
            if not (rows["n"] == arity).all():
                raise ValueError("face lists of mixed arity are not supported")
            out[name + "_indices"] = rows["idx"].astype(np.int32)
            offset += row.itemsize * count
            continue
        dtype = np.dtype([(p, "<" + t) for p, t in props])
        out[name] = np.frombuffer(body, dtype=dtype, count=count, offset=offset).copy()
        offset += dtype.itemsize * count
    return out


def structured_from_columns(columns: Mapping[str, np.ndarray]) -> np.ndarray:
    """Build a float32 structured array from named 1-D columns."""
    n = len(next(iter(columns.values())))
    dtype = np.dtype([(name, "<f4") for name in columns])
    arr = np.empty(n, dtype=dtype)
    for name, col in columns.items():
        arr[name] = np.asarray(col, dtype=np.float32).reshape(n)
    return arr


def write_ply_with_faces(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Write a binary mesh PLY: structured vertex element + triangle faces
    (``property list uchar int vertex_indices``)."""
    faces = np.ascontiguousarray(faces, dtype="<i4")
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {len(vertices)}"]
        for prop in vertices.dtype.names:
            header.append(f"property {_INV_DTYPES[vertices.dtype[prop].str[1:]]} {prop}")
        header += [
            f"element face {len(faces)}",
            "property list uchar int vertex_indices",
            "end_header",
        ]
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(vertices.astype(vertices.dtype.newbyteorder("<")).tobytes())
        rows = np.empty(len(faces), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
        rows["n"] = 3
        rows["idx"] = faces
        f.write(rows.tobytes())
