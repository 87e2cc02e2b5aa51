"""FileStorage persistence (core/src/persistence.cpp) — JSON, YAML and
XML backends, interchangeable with the reference (matrices as
opencv-matrix nodes).  The YAML/XML emit matches the reference's layout
(`%YAML 1.2` documents / `<opencv_storage>` roots); readers accept the
subset the writers produce plus plain nested scalars.

Twin of ``opencv_tpu/persistence.py``: the same files byte for byte.  A
matrix may be a numpy array or a tensor on any device, which is read back
once (``core.arrays.to_host``); numbers are written with ``repr(float)``, so
an f64 matrix comes back bit for bit."""

from __future__ import annotations

import json

import numpy as np
import torch

from .core.arrays import to_host

__all__ = ["FileStorage", "FILE_STORAGE_READ", "FILE_STORAGE_WRITE"]

FILE_STORAGE_READ = 0
FILE_STORAGE_WRITE = 1
FILE_STORAGE_APPEND = 2

_DT = {"u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16,
       "i": np.int32, "f": np.float32, "d": np.float64}
_DT_INV = {np.dtype(v): k for k, v in _DT.items()}


class FileNode:
    def __init__(self, val):
        self._v = val

    def empty(self):
        return self._v is None

    def isNone(self):
        return self._v is None

    def real(self):
        return float(self._v)

    def string(self):
        return str(self._v)

    def mat(self):
        v = self._v
        if isinstance(v, dict) and v.get("type_id") == "opencv-matrix":
            dt = v["dt"]
            cn = 1
            if len(dt) > 1 and dt[0].isdigit():
                cn = int(dt[:-1])
                dt = dt[-1]
            arr = np.asarray(v["data"], _DT[dt])
            shape = (v["rows"], v["cols"]) if cn == 1 \
                else (v["rows"], v["cols"], cn)
            return arr.reshape(shape)
        return np.asarray(v)

    def __getitem__(self, key):
        return FileNode(self._v.get(key) if isinstance(self._v, dict) else None)


class FileStorage:
    def __init__(self, filename=None, flags=FILE_STORAGE_READ):
        self._data = {}
        self._file = filename
        self._mode = flags
        self._open = False
        if filename:
            self.open(filename, flags)

    def _fmt(self):
        name = (self._file or "").lower()
        if name.endswith(".xml"):
            return "xml"
        if name.endswith(".yml") or name.endswith(".yaml"):
            return "yaml"
        return "json"

    def open(self, filename, flags):
        self._file = filename
        self._mode = flags
        if flags == FILE_STORAGE_READ:
            with open(filename) as f:
                text = f.read()
            fmt = self._fmt()
            if fmt == "json":
                self._data = json.loads(text)
            elif fmt == "yaml":
                self._data = _yaml_load(text)
            else:
                self._data = _xml_load(text)
        else:
            self._data = {}
        self._open = True
        return True

    def isOpened(self):
        return self._open

    def write(self, name, value):
        if isinstance(value, torch.Tensor):
            value = to_host(value)
        if isinstance(value, np.ndarray):
            cn = value.shape[2] if value.ndim == 3 else 1
            dt = _DT_INV[value.dtype]
            if cn > 1:
                dt = f"{cn}{dt}"
            self._data[name] = {
                "type_id": "opencv-matrix",
                "rows": int(value.shape[0]),
                "cols": int(value.shape[1]) if value.ndim >= 2 else 1,
                "dt": dt,
                "data": np.asarray(value).ravel().tolist(),
            }
        elif isinstance(value, (int, float, str)):
            self._data[name] = value
        else:
            self._data[name] = value

    def getNode(self, name):
        return FileNode(self._data.get(name))

    def release(self):
        if self._mode in (FILE_STORAGE_WRITE, FILE_STORAGE_APPEND) \
                and self._file:
            fmt = self._fmt()
            with open(self._file, "w") as f:
                if fmt == "json":
                    json.dump(self._data, f)
                elif fmt == "yaml":
                    f.write(_yaml_dump(self._data))
                else:
                    f.write(_xml_dump(self._data))
        self._open = False


# ------------------------------------------------------------- YAML mode

def _fmt_num(v, dt):
    if dt in "ucwsi":
        return str(int(v))
    s = repr(float(v))
    if s.endswith(".0"):
        s = s[:-1]
    return s


def _yaml_dump(data):
    out = ["%YAML 1.2", "---"]
    for name, v in data.items():
        if isinstance(v, dict) and v.get("type_id") == "opencv-matrix":
            dt = v["dt"][-1]
            vals = ", ".join(_fmt_num(x, dt) for x in v["data"])
            out.append(f"{name}: !!opencv-matrix")
            out.append(f"   rows: {v['rows']}")
            out.append(f"   cols: {v['cols']}")
            out.append(f"   dt: {v['dt']}")
            out.append(f"   data: [ {vals} ]")
        elif isinstance(v, float):
            out.append(f"{name}: {_fmt_num(v, 'd')}")
        elif isinstance(v, str):
            out.append(f"{name}: {v}")
        else:
            out.append(f"{name}: {v}")
    return "\n".join(out) + "\n"


def _yaml_scalar(tok):
    tok = tok.strip()
    if tok.startswith('"') and tok.endswith('"'):
        return tok[1:-1]
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok


def _yaml_load(text):
    lines = [l for l in text.splitlines()
             if l.strip() and not l.startswith("%") and l.strip() != "---"
             and not l.lstrip().startswith("#")]
    data = {}
    i = 0
    while i < len(lines):
        line = lines[i]
        if ":" not in line:
            i += 1
            continue
        name, rest = line.split(":", 1)
        name = name.strip()
        rest = rest.strip()
        if rest.startswith("!!opencv-matrix") or rest == "":
            node = {"type_id": "opencv-matrix"}
            i += 1
            databuf = None
            while i < len(lines) and (lines[i].startswith("   ")
                                      or lines[i].startswith("\t")
                                      or databuf is not None):
                sub = lines[i].strip()
                if databuf is not None:
                    databuf += " " + sub
                    if "]" in sub:
                        node["data"] = databuf
                        databuf = None
                    i += 1
                    continue
                if ":" in sub:
                    k, val = sub.split(":", 1)
                    val = val.strip()
                    if k.strip() == "data" and "]" not in val:
                        databuf = val
                        i += 1
                        continue
                    node[k.strip()] = val
                i += 1
            # parse matrix fields
            dt = node.get("dt", "d")
            raw = node.get("data", "[]")
            raw = raw.strip().lstrip("[").rstrip("]")
            vals = [_yaml_scalar(t) for t in raw.split(",") if t.strip()]
            data[name] = {"type_id": "opencv-matrix",
                          "rows": int(node.get("rows", 0)),
                          "cols": int(node.get("cols", 1)),
                          "dt": dt, "data": vals}
        else:
            data[name] = _yaml_scalar(rest)
            i += 1
    return data


# -------------------------------------------------------------- XML mode

def _xml_dump(data):
    out = ['<?xml version="1.0"?>', "<opencv_storage>"]
    for name, v in data.items():
        if isinstance(v, dict) and v.get("type_id") == "opencv-matrix":
            dt = v["dt"][-1]
            vals = " ".join(_fmt_num(x, dt) for x in v["data"])
            out.append(f'<{name} type_id="opencv-matrix">')
            out.append(f"  <rows>{v['rows']}</rows>")
            out.append(f"  <cols>{v['cols']}</cols>")
            out.append(f"  <dt>{v['dt']}</dt>")
            out.append("  <data>")
            out.append(f"    {vals}</data></{name}>")
        elif isinstance(v, str):
            out.append(f'<{name}>"{v}"</{name}>')
        elif isinstance(v, float):
            out.append(f"<{name}>{_fmt_num(v, 'd')}</{name}>")
        else:
            out.append(f"<{name}>{v}</{name}>")
    out.append("</opencv_storage>")
    return "\n".join(out) + "\n"


def _xml_load(text):
    import xml.etree.ElementTree as ET
    root = ET.fromstring(text)
    data = {}
    for child in root:
        if child.get("type_id") == "opencv-matrix":
            node = {"type_id": "opencv-matrix"}
            for sub in child:
                if sub.tag == "data":
                    node["data"] = [_yaml_scalar(t)
                                    for t in (sub.text or "").split()]
                elif sub.tag in ("rows", "cols"):
                    node[sub.tag] = int(sub.text)
                else:
                    node[sub.tag] = (sub.text or "").strip()
            data[child.tag] = node
        else:
            txt = (child.text or "").strip()
            if txt.startswith('"') and txt.endswith('"'):
                data[child.tag] = txt[1:-1]
            else:
                data[child.tag] = _yaml_scalar(txt)
    return data
