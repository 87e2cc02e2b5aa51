"""Point-cloud / mesh file IO (the 5.x 3d module's loadPointCloud
family): ascii PLY and OBJ, matching the wheel's header layout and its
[0,1]-normalized float color convention.  Twin of
``opencv_tpu/threed/pointcloud.py``, copied: file IO is host work, and a
file either package writes is byte for byte the other's.  The savers read
tensor arguments (a Volume's points on the card) back once."""

from __future__ import annotations

import os

import numpy as np

from ..core.arrays import to_host

__all__ = ["loadPointCloud", "savePointCloud", "loadMesh", "saveMesh"]


def _write_ply(path, v, normals=None, rgb=None, faces=None):
    v = np.asarray(v, np.float32).reshape(-1, 3)
    lines = ["ply", "format ascii 1.0", "comment created by opencv_tpu",
             f"element vertex {len(v)}",
             "property float x", "property float y", "property float z"]
    if normals is not None:
        lines += ["property float nx", "property float ny",
                  "property float nz"]
    if rgb is not None:
        lines += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    if faces is not None:
        lines += [f"element face {len(faces)}",
                  "property list uchar int vertex_indices"]
    lines.append("end_header")
    body = []
    nr = (np.asarray(normals, np.float32).reshape(-1, 3)
          if normals is not None else None)
    cl = (np.clip(np.round(np.asarray(rgb, np.float64)
                           .reshape(-1, 3) * 255), 0, 255).astype(int)
          if rgb is not None else None)
    for i, p in enumerate(v):
        parts = [f"{p[0]:g}", f"{p[1]:g}", f"{p[2]:g}"]
        if nr is not None:
            parts += [f"{nr[i][0]:g}", f"{nr[i][1]:g}", f"{nr[i][2]:g}"]
        if cl is not None:
            parts += [str(cl[i][0]), str(cl[i][1]), str(cl[i][2])]
        body.append(" ".join(parts))
    if faces is not None:
        for f in faces:
            f = np.asarray(f).ravel()
            body.append(str(len(f)) + " " + " ".join(str(int(x))
                                                     for x in f))
    with open(path, "w") as fh:
        fh.write("\n".join(lines + body) + "\n")


def _write_obj(path, v, normals=None, rgb=None, faces=None):
    v = np.asarray(v, np.float32).reshape(-1, 3)
    out = ["# OBJ file writer", "o Point_Cloud"]
    for p in v:
        out.append(f"v {p[0]:g} {p[1]:g} {p[2]:g}")
    if normals is not None:
        for p in np.asarray(normals, np.float32).reshape(-1, 3):
            out.append(f"vn {p[0]:g} {p[1]:g} {p[2]:g}")
    if faces is not None:
        for f in faces:
            f = np.asarray(f).ravel()
            out.append("f " + " ".join(str(int(x) + 1) for x in f))
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")


def _parse_ply(path):
    with open(path, "rb") as fh:
        text = fh.read().decode("latin-1")
    lines = text.splitlines()
    i = 0
    nvert = nface = 0
    vprops = []
    in_vertex = False
    while i < len(lines):
        t = lines[i].strip()
        i += 1
        if t.startswith("element vertex"):
            nvert = int(t.split()[-1])
            in_vertex = True
        elif t.startswith("element face"):
            nface = int(t.split()[-1])
            in_vertex = False
        elif t.startswith("property") and in_vertex:
            vprops.append(t.split()[-1])
        elif t == "end_header":
            break
    verts = np.zeros((nvert, 3), np.float32)
    normals = np.zeros((nvert, 3), np.float32) if "nx" in vprops else None
    rgb = np.zeros((nvert, 3), np.float32) if "red" in vprops else None
    for k in range(nvert):
        vals = lines[i + k].split()
        m = dict(zip(vprops, vals))
        verts[k] = [float(m["x"]), float(m["y"]), float(m["z"])]
        if normals is not None:
            normals[k] = [float(m["nx"]), float(m["ny"]), float(m["nz"])]
        if rgb is not None:
            rgb[k] = [int(float(m["red"])) % 256 / 255.0,
                      int(float(m["green"])) % 256 / 255.0,
                      int(float(m["blue"])) % 256 / 255.0]
    i += nvert
    faces = []
    for k in range(nface):
        vals = [int(x) for x in lines[i + k].split()]
        faces.append(np.asarray(vals[1:1 + vals[0]], np.int32))
    return verts, normals, rgb, faces


def _parse_obj(path):
    verts, normals, faces = [], [], []
    with open(path) as fh:
        for line in fh:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(x) for x in t[1:4]])
            elif t[0] == "vn":
                normals.append([float(x) for x in t[1:4]])
            elif t[0] == "f":
                faces.append(np.asarray(
                    [int(x.split("/")[0]) - 1 for x in t[1:]], np.int32))
    return (np.asarray(verts, np.float32),
            np.asarray(normals, np.float32) if normals else None,
            None, faces)


def _host(a):
    return None if a is None else to_host(a)


def savePointCloud(filename: str, vertices, normals=None, rgb=None):
    vertices, normals, rgb = _host(vertices), _host(normals), _host(rgb)
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".ply":
        _write_ply(filename, vertices, normals, rgb)
    elif ext == ".obj":
        _write_obj(filename, vertices, normals, rgb)
    else:
        raise ValueError(f"unsupported point cloud format {ext}")


def loadPointCloud(filename: str, vertices=None, normals=None, rgb=None):
    ext = os.path.splitext(filename)[1].lower()
    v, n, c, _f = (_parse_ply(filename) if ext == ".ply"
                   else _parse_obj(filename))
    sh = (-1, 1, 3)
    return (v.reshape(sh),
            None if n is None or not len(n) else n.reshape(sh),
            None if c is None else c.reshape(sh))


def saveMesh(filename: str, vertices, indices, normals=None, colors=None,
             texCoords=None):
    vertices, normals, colors = _host(vertices), _host(normals), _host(colors)
    indices = [to_host(f) for f in indices]
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".ply":
        _write_ply(filename, vertices, normals, colors, faces=indices)
    elif ext == ".obj":
        _write_obj(filename, vertices, normals, colors, faces=indices)
    else:
        raise ValueError(f"unsupported mesh format {ext}")


def loadMesh(filename: str, *args):
    ext = os.path.splitext(filename)[1].lower()
    v, n, c, f = (_parse_ply(filename) if ext == ".ply"
                  else _parse_obj(filename))
    verts = v.reshape(1, -1, 3)
    return (verts, [fi for fi in f],
            None if n is None or not len(n) else n.reshape(1, -1, 3),
            None if c is None else c.reshape(1, -1, 3), None)
