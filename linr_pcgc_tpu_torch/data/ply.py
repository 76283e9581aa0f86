"""Pure-numpy PLY geometry IO (a copy of linr_pcgc_tpu/data/ply.py).

Replaces the reference's Open3D (C++) dependency (custom_dataset.py:10-58)
with a dependency-free reader/writer.  Supports ascii and
binary_little_endian PLY with x/y/z vertex properties of any numeric type;
extra vertex properties (color, normals) are skipped, extra elements
(faces) are ignored — only geometry matters to this codec.

The ascii writer emits the same shape of file the reference decoder writes
(header with ``property float x/y/z``, integer coordinate rows,
custom_dataset.py:37-58) so downstream PCC tooling treats outputs
identically.
"""

from __future__ import annotations

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


def read_ply(path: str, dtype="int32") -> np.ndarray:
    """Read vertex x/y/z from an ascii or binary_little_endian PLY file."""
    with open(path, "rb") as f:
        data = f.read()

    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    nl = data.find(b"\n", end)
    header = data[:nl].decode("ascii", "replace").splitlines()
    body = data[nl + 1:]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype_str), ...])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[-1], "list:" + parts[2] + ":" + parts[3]))
            else:
                elements[-1][2].append((parts[2], _PLY_DTYPES[parts[1]]))

    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"{path}: unsupported PLY format {fmt}")

    vertex = next((e for e in elements if e[0] == "vertex"), None)
    if vertex is None:
        raise ValueError(f"{path}: no vertex element")
    _, count, props = vertex
    names = [p[0] for p in props]
    for axis in ("x", "y", "z"):
        if axis not in names:
            raise ValueError(f"{path}: vertex element lacks property {axis}")

    if fmt == "ascii":
        # vertex is conventionally the first element; faces follow.
        rows = np.loadtxt(
            body.splitlines()[:count],
            dtype=np.float64,
            usecols=[names.index(a) for a in ("x", "y", "z")],
            ndmin=2,
        )
        coords = rows
    else:
        if any(d.startswith("list:") for _, d in props):
            raise ValueError(f"{path}: list property inside vertex unsupported")
        if elements[0][0] != "vertex":
            # skip preceding fixed-size elements
            offset = 0
            for name, cnt, ps in elements:
                if name == "vertex":
                    break
                offset += cnt * sum(np.dtype("<" + d).itemsize for _, d in ps)
            body = body[offset:]
        rec = np.dtype([(n, "<" + d) for n, d in props])
        arr = np.frombuffer(body, dtype=rec, count=count)
        coords = np.stack(
            [arr["x"].astype(np.float64), arr["y"].astype(np.float64), arr["z"].astype(np.float64)],
            axis=1,
        )
    return coords.astype(dtype)


def write_ply_ascii(path: str, coords: np.ndarray, dtype="int32") -> None:
    coords = np.asarray(coords).astype(dtype)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {coords.shape[0]}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "end_header\n"
        )
        np.savetxt(f, coords, fmt="%d")


def write_ply_binary(path: str, coords: np.ndarray) -> None:
    coords = np.asarray(coords).astype("<f4")
    with open(path, "wb") as f:
        f.write(
            (
                "ply\nformat binary_little_endian 1.0\n"
                f"element vertex {coords.shape[0]}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "end_header\n"
            ).encode("ascii")
        )
        f.write(coords.tobytes())
