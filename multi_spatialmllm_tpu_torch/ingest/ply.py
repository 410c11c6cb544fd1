"""Minimal PLY reader (ascii + binary little-endian).

Replaces the reference's `plyfile` dependency (scannet_utils.py:145-165)
with a self-contained parser sufficient for ScanNet `_vh_clean_2.ply`
meshes: reads any element into a NumPy structured array; helper returns the
`[N, 6]` xyz+rgb float32 layout the pipeline consumes.
"""

from __future__ import annotations

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Parse a PLY file into {element_name: structured array}.

    Supports `format ascii 1.0` and `format binary_little_endian 1.0`;
    list properties (e.g. face vertex_indices) are parsed and exposed as
    object arrays for ascii, and skipped-by-stride for binary faces with
    uchar-count lists (the ScanNet case).
    """
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements: list[tuple[str, int, list]] = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unterminated PLY header")
            tokens = line.decode("ascii", "replace").split()
            if not tokens:
                continue
            if tokens[0] == "comment":
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append((tokens[1], int(tokens[2]), []))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    elements[-1][2].append(
                        ("list", tokens[4], _PLY_TYPES[tokens[2]],
                         _PLY_TYPES[tokens[3]]))
                else:
                    elements[-1][2].append(
                        ("scalar", tokens[2], _PLY_TYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"unsupported PLY format: {fmt}")

        out: dict[str, np.ndarray] = {}
        for name, count, props in elements:
            has_list = any(p[0] == "list" for p in props)
            if not has_list:
                dtype = np.dtype(
                    [(p[1], "<" + p[2]) for p in props])
                if fmt == "binary_little_endian":
                    out[name] = np.frombuffer(
                        f.read(dtype.itemsize * count), dtype=dtype,
                        count=count).copy()
                else:
                    rows = []
                    for _ in range(count):
                        rows.append(tuple(f.readline().split()))
                    out[name] = np.array(
                        [tuple(float(v) for v in r) for r in rows],
                        dtype=dtype)
            else:
                # list elements (faces): parse but return as object array
                faces = []
                if fmt == "binary_little_endian":
                    (kind, pname, cnt_t, val_t) = props[0]
                    cnt_dt = np.dtype("<" + cnt_t)
                    val_dt = np.dtype("<" + val_t)
                    for _ in range(count):
                        n = int(np.frombuffer(f.read(cnt_dt.itemsize),
                                              dtype=cnt_dt)[0])
                        faces.append(np.frombuffer(
                            f.read(val_dt.itemsize * n), dtype=val_dt).copy())
                else:
                    for _ in range(count):
                        vals = f.readline().split()
                        n = int(vals[0])
                        faces.append(
                            np.array(vals[1:1 + n], dtype=np.int64))
                arr = np.empty(count, dtype=object)
                for i, face in enumerate(faces):
                    arr[i] = face
                out[name] = arr
        return out


def read_mesh_vertices_rgb(path: str) -> np.ndarray:
    """`[N, 6]` float32 xyz + rgb(0-255). Parity: scannet_utils.py:145-165."""
    vertex = read_ply(path)["vertex"]
    out = np.zeros((len(vertex), 6), dtype=np.float32)
    for i, field in enumerate(("x", "y", "z", "red", "green", "blue")):
        out[:, i] = vertex[field]
    return out


def write_ply_vertices(path: str, xyz: np.ndarray, rgb: np.ndarray,
                       binary: bool = True) -> None:
    """Write a vertex-only PLY (used by tests/fixtures)."""
    n = xyz.shape[0]
    header = (
        "ply\n"
        f"format {'binary_little_endian' if binary else 'ascii'} 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                      ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec = np.empty(n, dtype=dtype)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(rec.tobytes())
        else:
            for r in rec:
                f.write((f"{r['x']} {r['y']} {r['z']} "
                         f"{r['red']} {r['green']} {r['blue']}\n")
                        .encode("ascii"))
