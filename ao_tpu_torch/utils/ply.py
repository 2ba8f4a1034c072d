"""PLY reader and writer (port of ao_tpu/utils/ply.py; reference:
pointcept/utils/ply.py).

``write_ply`` writes named vertex properties, each a column of an (N,) or
(N, k) array, with optional triangular faces, as binary PLY in the
machine's byte order (byte for byte the JAX package's file) or, with
``binary=False``, as ascii PLY. ``read_ply`` reads both formats (either
byte order), returning a structured array of the vertex properties and,
with ``triangular_mesh=True``, the (F, 3) int32 faces.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import numpy as np

_PLY_DTYPES = {
    np.dtype("int8"): "char",
    np.dtype("uint8"): "uchar",
    np.dtype("int16"): "short",
    np.dtype("uint16"): "ushort",
    np.dtype("int32"): "int",
    np.dtype("uint32"): "uint",
    np.dtype("float32"): "float",
    np.dtype("float64"): "double",
}
_INV_PLY_DTYPES = {v: k for k, v in _PLY_DTYPES.items()}
# the sized aliases some writers use
_INV_PLY_DTYPES.update({str(d): d for d in _PLY_DTYPES})
_FACE_FIELDS = [("k", np.uint8), ("v1", np.int32), ("v2", np.int32),
                ("v3", np.int32)]


def _columns(field_list):
    fields = []
    for f in field_list:
        f = np.asarray(f)
        fields.append(f[:, None] if f.ndim == 1 else f)
    return fields


def write_ply(
    filename: str,
    field_list: Sequence[np.ndarray],
    field_names: Sequence[str],
    triangular_faces: Optional[np.ndarray] = None,
    binary: bool = True,
) -> bool:
    """Write the columns of ``field_list`` as vertex properties named
    ``field_names`` (".ply" is appended to a name without it)."""
    if not filename.endswith(".ply"):
        filename += ".ply"
    fields = _columns(field_list)
    n = fields[0].shape[0]
    if any(f.shape[0] != n for f in fields):
        raise ValueError("write_ply: the fields' row counts differ")
    if sum(f.shape[1] for f in fields) != len(field_names):
        raise ValueError("write_ply: one name a column")
    if binary:
        fmt = ("binary_little_endian" if sys.byteorder == "little"
               else "binary_big_endian")
    else:
        fmt = "ascii"
    types = [f.dtype for f in fields for _ in range(f.shape[1])]
    header = ["ply", f"format {fmt} 1.0", f"element vertex {n}"]
    header += [f"property {_PLY_DTYPES[t]} {name}"
               for t, name in zip(types, field_names)]
    if triangular_faces is not None:
        header += [f"element face {triangular_faces.shape[0]}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")
    data = np.empty(n, dtype=list(zip(field_names, types)))
    columns = [f[:, c] for f in fields for c in range(f.shape[1])]
    for name, col in zip(field_names, columns):
        data[name] = col
    faces = (None if triangular_faces is None
             else np.asarray(triangular_faces, np.int32))
    with open(filename, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        if not binary:
            for row in data.tolist():
                fh.write((" ".join(repr(v) if isinstance(v, float) else str(v)
                                   for v in row) + "\n").encode("ascii"))
            if faces is not None:
                for a, b, c in faces.tolist():
                    fh.write(f"3 {a} {b} {c}\n".encode("ascii"))
            return True
        data.tofile(fh)
        if faces is not None:
            rec = np.empty(faces.shape[0], dtype=_FACE_FIELDS)
            rec["k"] = 3
            rec["v1"], rec["v2"], rec["v3"] = faces[:, 0], faces[:, 1], faces[:, 2]
            rec.tofile(fh)
    return True


def read_ply(filename: str, triangular_mesh: bool = False):
    """The vertex properties of a PLY file as a structured array, and with
    ``triangular_mesh`` and faces in the file, (vertex, its (F, 3) faces)."""
    with open(filename, "rb") as fh:
        if fh.readline().strip() != b"ply":
            raise ValueError(f"{filename}: not a ply file")
        fmt, num_points, num_faces, element = None, 0, 0, None
        props: List = []
        while True:
            line = fh.readline()
            if not line:
                raise ValueError(f"{filename}: no end_header")
            parts = line.strip().decode("ascii").split()
            if parts == ["end_header"]:
                break
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                element = parts[1]
                if element == "vertex":
                    num_points = int(parts[2])
                elif element == "face":
                    num_faces = int(parts[2])
            elif parts[0] == "property" and element == "vertex":
                props.append((parts[2], _INV_PLY_DTYPES[parts[1]]))
        if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
            raise ValueError(f"{filename}: format {fmt!r}")
        if fmt == "ascii":
            rows = fh.read().decode("ascii").splitlines()
            table = np.array([r.split() for r in rows[:num_points]],
                             dtype=str).reshape(num_points, len(props))
            vertex = np.empty(num_points, dtype=props)
            for c, (name, t) in enumerate(props):
                vertex[name] = table[:, c].astype(np.float64 if t.kind == "f"
                                                  else np.int64).astype(t)
            faces = np.array(
                [[int(v) for v in r.split()[1:4]]
                 for r in rows[num_points:num_points + num_faces]],
                np.int32).reshape(-1, 3)
        else:
            order = "<" if fmt == "binary_little_endian" else ">"
            dtype = np.dtype([(n, t.newbyteorder(order)) for n, t in props])
            vertex = np.fromfile(fh, dtype=dtype, count=num_points)
            vertex = vertex.astype(np.dtype(props))
            face_dtype = np.dtype([(n, np.dtype(t).newbyteorder(order))
                                   for n, t in _FACE_FIELDS])
            rec = np.fromfile(fh, dtype=face_dtype, count=num_faces)
            faces = np.stack([rec["v1"], rec["v2"], rec["v3"]],
                             axis=1).astype(np.int32)
    if triangular_mesh and num_faces:
        return vertex, faces
    return vertex
