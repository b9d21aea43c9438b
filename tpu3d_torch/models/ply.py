"""PLY point-cloud I/O.

The reference ships a minimal ASCII-only parser (registration.cpp:416-461):
vertex count from the header, color detection via a "red"/"diffuse_red"
substring, colors divided by 255 when any component exceeds 1.0, everything
after x y z (r g b) on a line ignored. This loader keeps those semantics and
extends coverage to binary_little_endian (a capability superset — real
scanner output is binary). A copy of ``tpu3d/models/ply.py``: the port's
C++ parser (``tpu3d_torch.native``) reads the file when the host runtime
is built, and this numpy reader takes what it declines. The C++ parser
comes first because it is the faster: ~55 ms against ~910 on the bin
frame's 921,600-point ASCII reference (``chip_smoke.py`` phase 5d, on the
host of an H100 machine).
"""

from __future__ import annotations


import numpy as np

_PLY_DTYPES = {
    "float": ("f4", 4),
    "float32": ("f4", 4),
    "double": ("f8", 8),
    "float64": ("f8", 8),
    "uchar": ("u1", 1),
    "uint8": ("u1", 1),
    "char": ("i1", 1),
    "int8": ("i1", 1),
    "ushort": ("u2", 2),
    "uint16": ("u2", 2),
    "short": ("i2", 2),
    "int16": ("i2", 2),
    "uint": ("u4", 4),
    "uint32": ("u4", 4),
    "int": ("i4", 4),
    "int32": ("i4", 4),
}


def load_ply(path: str):
    """Returns (points f32[N,3], colors f32[N,3] | None).

    Missing file → empty arrays + stderr message, matching
    registration.cpp:419-423's degrade-don't-throw behavior.
    """
    from tpu3d_torch import native

    if native.available():
        out = native.load_ply(path)
        if out is not None:
            return out
    try:
        f = open(path, "rb")
    except OSError:
        import sys

        print(f"Cannot open reference model: {path}", file=sys.stderr)
        return np.zeros((0, 3), np.float32), None

    with f:
        fmt = "ascii"
        vertex_count = 0
        props: list[tuple[str, str]] = []  # (name, type) of the vertex element
        in_vertex = False
        while True:
            raw_line = f.readline()
            if not raw_line:  # EOF before end_header: malformed/truncated
                print(f"Malformed PLY header (no end_header): {path}",
                      file=__import__("sys").stderr)
                return np.zeros((0, 3), np.float32), None
            line = raw_line.decode("ascii", errors="replace").strip()
            toks = line.split()
            if not toks:
                continue
            if toks[0] == "format" and len(toks) >= 2:
                fmt = toks[1]
            elif toks[0] == "element" and len(toks) >= 3:
                in_vertex = toks[1] == "vertex"
                if in_vertex:
                    vertex_count = int(toks[2])
            elif toks[0] == "property" and in_vertex and len(toks) >= 3:
                props.append((toks[-1], toks[1]))
            elif toks[0] == "end_header":
                break

        names = [p[0] for p in props]
        # registration.cpp:434-436 substring detection, made exact — and
        # gated on the full rgb triple actually being declared (the
        # reference assumes green/blue follow red; we look them up by name).
        _pre = "" if "red" in names else (
            "diffuse_" if "diffuse_red" in names else None
        )
        has_color = _pre is not None and all(
            _pre + c in names for c in ("green", "blue")
        )
        if not props:  # reference-grade fallback: assume x y z (r g b)
            names = ["x", "y", "z"]
            props = [("x", "float"), ("y", "float"), ("z", "float")]

        if fmt == "ascii":
            cols = None
            stride = len(props)
            xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
            body = f.read()
            data = body.split()
            if len(data) == vertex_count * stride:
                vals = np.asarray(data, dtype=np.float32).reshape(
                    vertex_count, stride
                )
            else:
                # Lines carry extra (or missing) tokens beyond the declared
                # properties — parse per line like the reference
                # (registration.cpp:440-451 reads exactly the leading fields
                # of each vertex line and ignores trailing extras).
                vals = np.zeros((vertex_count, stride), np.float32)
                lines = body.splitlines()
                row = 0
                for ln in lines:
                    t = ln.split()
                    if not t:
                        continue
                    if row >= vertex_count:
                        break
                    take = min(len(t), stride)
                    vals[row, :take] = [float(v) for v in t[:take]]
                    row += 1
            pts = np.stack(
                [vals[:, xi], vals[:, yi], vals[:, zi]], axis=1
            ).astype(np.float32)
            if has_color:
                ci = [names.index(_pre + c) for c in ("red", "green", "blue")]
                cols = vals[:, ci].astype(np.float32)
        else:
            little = "little" in fmt
            rec = np.dtype(
                [
                    (n or f"f{i}", ("<" if little else ">") + _PLY_DTYPES[t][0])
                    for i, (n, t) in enumerate(props)
                ]
            )
            raw = np.frombuffer(f.read(rec.itemsize * vertex_count), dtype=rec)
            pts = np.stack(
                [raw["x"], raw["y"], raw["z"]], axis=1
            ).astype(np.float32)
            cols = None
            if has_color:
                cols = np.stack(
                    [raw[_pre + "red"], raw[_pre + "green"], raw[_pre + "blue"]],
                    axis=1,
                ).astype(np.float32)

        if cols is not None and cols.size and cols.max() > 1.0:
            cols = cols / np.float32(255.0)  # registration.cpp:453
        return pts, cols


def save_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None):
    """ASCII PLY writer (viewer/debug exports; no reference analog)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        if colors is None:
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
        else:
            c255 = np.clip(np.asarray(colors) * 255.0, 0, 255).astype(np.uint8)
            for p, c in zip(points, c255):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
