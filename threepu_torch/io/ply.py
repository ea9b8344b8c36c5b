"""PLY reader and writer in numpy (own copy of ``threepu/io/ply.py``; the
files the two write are byte-identical).

Vertices with optional normals and colours, faces with optional colours,
and the colormap-property variants.  Reads ascii and binary little- and
big-endian; writes binary little-endian.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from threepu_torch.utils.pc_utils import downsample_points

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {
    "int8": "char", "uint8": "uchar", "int16": "short", "uint16": "ushort",
    "int32": "int", "uint32": "uint", "float32": "float", "float64": "double",
}

#: a property: ``(name, numpy type)``, or ``(name, (count type, item
#: type))`` for a list
Property = Tuple[str, object]
#: an element of the header: ``(name, count, properties)``
Element = Tuple[str, int, List[Property]]


def _parse_header(f) -> Tuple[List[Element], str]:
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: List[Element] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        parts = line.decode("ascii", "replace").strip().split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                prop = (parts[4], (_PLY_TO_NP[parts[2]], _PLY_TO_NP[parts[3]]))
            else:
                prop = (parts[-1], _PLY_TO_NP[parts[1]])
            elements[-1][2].append(prop)
        elif parts[0] == "end_header":
            break
    if fmt is None:
        raise ValueError("PLY header missing format")
    return elements, fmt


def _read_ascii(f, elements: Sequence[Element]
                ) -> Dict[str, Dict[str, np.ndarray]]:
    body = f.read().decode("ascii").split()
    pos = 0
    out = {}
    for name, count, props in elements:
        cols: Dict[str, list] = {pname: [] for pname, _ in props}
        for _ in range(count):
            for pname, ptype in props:
                if isinstance(ptype, tuple):
                    cnt = int(body[pos])
                    cols[pname].append([float(v)
                                        for v in body[pos + 1:pos + 1 + cnt]])
                    pos += 1 + cnt
                else:
                    cols[pname].append(float(body[pos]))
                    pos += 1
        out[name] = {
            pname: np.asarray(cols[pname], np.float64).astype(
                ptype[1] if isinstance(ptype, tuple) else ptype)
            for pname, ptype in props}
    return out


def _read_binary(f, elements: Sequence[Element], endian: str
                 ) -> Dict[str, Dict[str, np.ndarray]]:
    def take(ptype: str, cnt: int = 1) -> np.ndarray:
        dt = np.dtype(endian + ptype)
        return np.frombuffer(f.read(dt.itemsize * cnt), dtype=dt)

    out = {}
    for name, count, props in elements:
        if not any(isinstance(ptype, tuple) for _, ptype in props):
            dt = np.dtype([(pname, endian + ptype) for pname, ptype in props])
            rec = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
            out[name] = {pname: rec[pname].copy() for pname, _ in props}
            continue
        # lists (faces) are read row by row; every row has one length
        rows: Dict[str, list] = {pname: [] for pname, _ in props}
        for _ in range(count):
            for pname, ptype in props:
                if isinstance(ptype, tuple):
                    cnt = int(take(ptype[0])[0])
                    rows[pname].append(take(ptype[1], cnt).copy())
                else:
                    rows[pname].append(take(ptype)[0])
        out[name] = {pname: np.stack(rows[pname]) for pname, _ in props}
    return out


def read_ply_data(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Every element of the file as ``{element: {property: array}}``; a
    list property comes back 2-D (one length for all rows)."""
    with open(path, "rb") as f:
        elements, fmt = _parse_header(f)
        if fmt == "ascii":
            return _read_ascii(f, elements)
        return _read_binary(f, elements,
                            "<" if fmt == "binary_little_endian" else ">")


def _vertex_points(data: Dict[str, np.ndarray]) -> np.ndarray:
    cols = [data["x"], data["y"], data["z"]]
    if "nx" in data:
        cols += [data["nx"], data["ny"], data["nz"]]
    return np.stack(cols, axis=1).astype(np.float32)


def resize_count(points: np.ndarray, count: int) -> np.ndarray:
    """``points`` padded with random repeats of its rows, or downsampled
    (:func:`~threepu_torch.utils.pc_utils.downsample_points`), to
    ``count`` rows; draws from numpy's global generator."""
    if count > points.shape[0]:
        extra = points[np.random.choice(points.shape[0],
                                        count - points.shape[0])]
        return np.concatenate([points, extra], axis=0)
    if count < points.shape[0]:
        return downsample_points(points, count)
    return points


def read_ply(path: str, count: Optional[int] = None) -> np.ndarray:
    """The vertices (with normals when the file has them) as float32
    ``(N, 3 or 6)``, resized to ``count`` rows when given
    (:func:`resize_count`)."""
    points = _vertex_points(read_ply_data(path)["vertex"])
    return points if count is None else resize_count(points, count)


def read_ply_with_color(path: str, count: Optional[int] = None):
    """``(points, colours)``: :func:`read_ply`'s points and the vertex
    colours scaled to [0, 1] (``None`` when the file has none)."""
    data = read_ply_data(path)["vertex"]
    points = _vertex_points(data)
    colors = None
    if "red" in data:
        names = ["red", "green", "blue"] + (["alpha"] if "alpha" in data
                                            else [])
        colors = np.stack([data[nm] for nm in names],
                          axis=1).astype(np.float32) / 255.0
    if count is not None:
        points = resize_count(points, count)
    return points, colors


def _write_header(f, elements: Sequence[Tuple[str, int,
                                              List[Tuple[str, str]]]]) -> None:
    """``elements``: ``(name, count, [(property, numpy type name or
    "list:<count type>:<item type>")])``."""
    f.write(b"ply\nformat binary_little_endian 1.0\n")
    f.write(b"comment produced by threepu\n")
    for name, count, props in elements:
        f.write(f"element {name} {count}\n".encode())
        for pname, ptype in props:
            if ptype.startswith("list:"):
                _, cdt, idt = ptype.split(":")
                f.write(f"property list {_NP_TO_PLY[cdt]} "
                        f"{_NP_TO_PLY[idt]} {pname}\n".encode())
            else:
                f.write(f"property {_NP_TO_PLY[ptype]} {pname}\n".encode())
    f.write(b"end_header\n")


def _as_uint8_colors(colors: np.ndarray) -> np.ndarray:
    """Colours in [0, 1] are scaled to [0, 255]."""
    colors = np.asarray(colors)
    if colors.max() <= 1:
        colors = colors * 255
    return colors.astype(np.uint8)


def _make_parent(filename: str) -> None:
    dirname = os.path.dirname(filename)
    if dirname:
        # exist_ok: the CLI writes a shape's two files from two threads
        os.makedirs(dirname, exist_ok=True)


_XYZ = [("x", "float32"), ("y", "float32"), ("z", "float32")]


def save_ply(points: np.ndarray, filename: str,
             colors: Optional[np.ndarray] = None,
             normals: Optional[np.ndarray] = None) -> None:
    """Write the vertices, with normals and colours when given, binary
    little-endian."""
    points = np.asarray(points, np.float32)
    props = list(_XYZ)
    fields = [points[:, :3]]
    if normals is not None:
        props += [("nx", "float32"), ("ny", "float32"), ("nz", "float32")]
        fields.append(np.asarray(normals, np.float32)[:, :3])
    if colors is not None:
        colors = _as_uint8_colors(colors)
        props += [(nm, "uint8") for nm in
                  ["red", "green", "blue", "alpha"][:colors.shape[1]]]
        fields.append(colors)
    rec = np.empty(points.shape[0], dtype=np.dtype(props))
    columns = [field[:, j] for field in fields for j in range(field.shape[1])]
    for (pname, _), column in zip(props, columns):
        rec[pname] = column
    _make_parent(filename)
    with open(filename, "wb") as f:
        _write_header(f, [("vertex", points.shape[0], props)])
        f.write(rec.tobytes())


def _cmap_colors(prop, property_max, cmap_name: str) -> np.ndarray:
    import matplotlib
    scaled = np.asarray(prop, np.float64) / property_max
    return np.asarray(matplotlib.colormaps[cmap_name](scaled))[:, :3]


def save_ply_property(points, prop, filename, property_max=None,
                      normals=None, cmap_name="Set1") -> None:
    """Vertices coloured by a scalar property through a matplotlib
    colormap (``property_max`` defaults to the property's maximum)."""
    if property_max is None:
        property_max = np.amax(np.asarray(prop, np.float64), axis=0)
    save_ply(points, filename, normals=normals,
             colors=_cmap_colors(prop, property_max, cmap_name))


def save_ply_with_face(points, faces, filename,
                       colors: Optional[np.ndarray] = None) -> None:
    """Vertices and faces (int32 vertex indices), with per-face colours
    when given."""
    points = np.asarray(points, np.float32)
    faces = np.asarray(faces, np.int32)
    fprops = [("vertex_indices", "list:uint8:int32")]
    if colors is not None:
        colors = _as_uint8_colors(colors)
        fprops += [("red", "uint8"), ("green", "uint8"), ("blue", "uint8")]
    rec = np.empty(points.shape[0], dtype=np.dtype(_XYZ))
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    _make_parent(filename)
    with open(filename, "wb") as f:
        _write_header(f, [("vertex", points.shape[0], _XYZ),
                          ("face", faces.shape[0], fprops)])
        f.write(rec.tobytes())
        for i in range(faces.shape[0]):
            f.write(np.uint8(faces.shape[1]).tobytes())
            f.write(faces[i].astype("<i4").tobytes())
            if colors is not None:
                f.write(colors[i, :3].tobytes())


def save_ply_with_face_property(points, faces, prop, property_max, filename,
                                cmap_name="Set1") -> None:
    """:func:`save_ply_with_face` with faces coloured by a scalar
    property through a matplotlib colormap."""
    save_ply_with_face(points, faces, filename,
                       _cmap_colors(prop, property_max, cmap_name))
