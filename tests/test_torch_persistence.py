"""The port's FileStorage (``opencv_tpu_torch/persistence.py``) against the
JAX package's: YAML, XML and JSON files of scalars, strings, sequences,
maps and matrices of u8, i32, f32 and f64 byte-equal between the packages,
each package reading the other's file to equal nodes, f64 values back bit
for bit, a written tensor equal to its numpy array; and against cv2's
FileStorage as tests/test_misc_modules.py and test_calib3d.py check it."""

import os

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import persistence as P

EXTS = ("yml", "xml", "json")


def _contents(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "count": 42,
        "neg": -7,
        "scale": 0.1,
        "big": 1.0e300,
        "whole": 3.0,
        "name": "hello",
        "seq": [1, 2, 3],
        "fseq": [0.5, -1.25],
        "tree": {"a": 1, "b": "x"},
        "u8": rng.integers(0, 256, (3, 4), np.uint8),
        "i32": rng.integers(-2 ** 31, 2 ** 31, (2, 5)).astype(np.int32),
        "f32": rng.standard_normal((4, 3)).astype(np.float32),
        "f64": rng.standard_normal((2, 3)) * 10.0 ** rng.integers(-30, 30, (2, 3)),
        "bgr": rng.integers(0, 256, (2, 3, 3), np.uint8),
        "row": rng.integers(0, 100, 5).astype(np.int32),
    }


def _write(mod, path, contents):
    fs = mod.FileStorage(path, mod.FILE_STORAGE_WRITE)
    for k, v in contents.items():
        fs.write(k, v)
    fs.release()
    with open(path, "rb") as f:
        return f.read()


def _node_value(node):
    v = node._v
    if isinstance(v, dict) and v.get("type_id") == "opencv-matrix":
        m = node.mat()
        return ("mat", m.dtype.str, m.shape, m.tobytes())
    return ("raw", repr(v))


@pytest.mark.parametrize("ext", EXTS)
def test_files_byte_equal_and_cross_read(tmp_path, ext):
    contents = _contents()
    ours = _write(tcv, str(tmp_path / f"ours.{ext}"), contents)
    theirs = _write(jcv, str(tmp_path / f"theirs.{ext}"), contents)
    assert ours == theirs
    for reader in (tcv, jcv):
        for name in ("ours", "theirs"):
            fs = reader.FileStorage(str(tmp_path / f"{name}.{ext}"), reader.FILE_STORAGE_READ)
            ref = jcv.FileStorage(str(tmp_path / f"theirs.{ext}"), jcv.FILE_STORAGE_READ)
            assert fs.isOpened()
            for k in contents:
                assert _node_value(fs.getNode(k)) == _node_value(ref.getNode(k)), (ext, k)
            assert fs.getNode("missing").empty() and ref.getNode("missing").empty()


@pytest.mark.parametrize("ext", EXTS)
def test_matrices_and_scalars_come_back(tmp_path, ext):
    contents = _contents(1)
    path = str(tmp_path / f"m.{ext}")
    _write(tcv, path, contents)
    fs = tcv.FileStorage(path, tcv.FILE_STORAGE_READ)
    for k in ("u8", "i32", "f32", "f64", "bgr"):
        got = fs.getNode(k).mat()
        assert got.dtype == contents[k].dtype, k
        np.testing.assert_array_equal(got, contents[k])
    # f64 bit for bit (repr(float) on write)
    assert fs.getNode("f64").mat().tobytes() == contents["f64"].tobytes()
    np.testing.assert_array_equal(fs.getNode("row").mat().ravel(), contents["row"])
    assert fs.getNode("count").real() == 42 and fs.getNode("neg").real() == -7
    assert fs.getNode("scale").real() == 0.1 and fs.getNode("big").real() == 1.0e300
    assert fs.getNode("whole").real() == 3.0
    assert fs.getNode("name").string() == "hello"
    if ext == "json":
        assert fs.getNode("seq")._v == [1, 2, 3] and fs.getNode("fseq")._v == [0.5, -1.25]
        assert fs.getNode("tree")["a"].real() == 1 and fs.getNode("tree")["b"].string() == "x"
    fs.release()
    assert not fs.isOpened()


@pytest.mark.parametrize("ext", EXTS)
def test_a_written_tensor_equals_its_array(tmp_path, ext):
    contents = _contents(2)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
               for k, v in contents.items()}
    # a strided view writes what its contiguous copy writes
    wide = torch.from_numpy(_contents(3)["f64"].repeat(2, axis=1))
    tensors["f64"], contents["f64"] = wide[:, ::2], wide[:, ::2].numpy().copy()
    a = _write(tcv, str(tmp_path / f"t.{ext}"), tensors)
    b = _write(tcv, str(tmp_path / f"n.{ext}"), contents)
    c = _write(jcv, str(tmp_path / f"j.{ext}"), contents)
    assert a == b == c


@pytest.mark.parametrize("ext", ("yml", "xml"))
def test_f64_matrix_bit_for_bit(tmp_path, ext):
    rng = np.random.default_rng(4)
    m = np.concatenate([rng.standard_normal(500), rng.random(500) * 1e-300,
                        [0.0, -0.0, 1.0, -2.5, 5e-324, 1.7976931348623157e308]]).reshape(-1, 2)
    path = str(tmp_path / f"f.{ext}")
    _write(tcv, path, {"M": m})
    got = tcv.FileStorage(path, tcv.FILE_STORAGE_READ).getNode("M").mat()
    assert got.dtype == np.float64 and got.tobytes() == m.tobytes()


def test_constants_equal_opencv_tpu():
    assert (P.FILE_STORAGE_READ, P.FILE_STORAGE_WRITE, P.FILE_STORAGE_APPEND) == \
        (jcv.persistence.FILE_STORAGE_READ, jcv.persistence.FILE_STORAGE_WRITE,
         jcv.persistence.FILE_STORAGE_APPEND)
    assert tcv.FILE_STORAGE_READ == cv2.FILE_STORAGE_READ
    assert tcv.FILE_STORAGE_WRITE == cv2.FILE_STORAGE_WRITE
    assert P.__all__ == jcv.persistence.__all__
    assert tcv.FileNode is P.FileNode and tcv.FileStorage is P.FileStorage


def test_filestorage_yaml_xml_json_cross_cv2(tmp_path):
    """tests/test_misc_modules.py::test_filestorage_yaml_xml_json_cross with
    the port: cv2 reads the port's files, the port reads cv2's."""
    M = np.arange(6, dtype=np.float64).reshape(2, 3) + 0.25
    B = np.arange(4, dtype=np.uint8).reshape(2, 2)
    for ext in EXTS:
        p = os.path.join(tmp_path, "ours." + ext)
        fs = tcv.FileStorage(p, tcv.FILE_STORAGE_WRITE)
        fs.write("M", torch.from_numpy(M))
        fs.write("count", 42)
        fs.write("name", "hello")
        fs.write("B", B)
        fs.release()
        rfs = cv2.FileStorage(p, cv2.FILE_STORAGE_READ)
        assert np.allclose(rfs.getNode("M").mat(), M), ext
        assert rfs.getNode("count").real() == 42
        assert rfs.getNode("name").string() == "hello"
        assert np.array_equal(rfs.getNode("B").mat(), B)
        p2 = os.path.join(tmp_path, "ref." + ext)
        wfs = cv2.FileStorage(p2, cv2.FILE_STORAGE_WRITE)
        wfs.write("M", M)
        wfs.write("count", 42)
        wfs.write("name", "hello")
        wfs.write("B", B)
        wfs.release()
        ofs = tcv.FileStorage(p2, tcv.FILE_STORAGE_READ)
        assert np.allclose(ofs.getNode("M").mat(), M), ext
        assert ofs.getNode("count").real() == 42
        assert ofs.getNode("name").string() == "hello"
        assert np.array_equal(ofs.getNode("B").mat(), B)
        jfs = jcv.FileStorage(p2, jcv.FILE_STORAGE_READ)
        for k in ("M", "count", "name", "B"):
            assert _node_value(ofs.getNode(k)) == _node_value(jfs.getNode(k)), (ext, k)


def test_file_storage_roundtrip_cv2_reads_json(tmp_path):
    """tests/test_calib3d.py::test_file_storage_roundtrip with the port."""
    p = str(tmp_path / "data.json")
    fs = tcv.FileStorage(p, tcv.FILE_STORAGE_WRITE)
    M = np.arange(12, dtype=np.float32).reshape(3, 4)
    fs.write("mat", M)
    fs.write("scalar", 3.5)
    fs.write("name", "hello")
    fs.release()
    fr = tcv.FileStorage(p, tcv.FILE_STORAGE_READ)
    assert np.array_equal(fr.getNode("mat").mat(), M)
    assert fr.getNode("scalar").real() == 3.5
    assert fr.getNode("name").string() == "hello"
    rf = cv2.FileStorage(p, cv2.FILE_STORAGE_READ)
    assert np.array_equal(rf.getNode("mat").mat(), M)
