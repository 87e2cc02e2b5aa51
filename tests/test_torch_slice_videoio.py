"""The video-file path, ``entry.forward_videoio``, on the CPU: the motion
video's frames as a HuffYUV AVI and the flagship's parameters as a
FileStorage YAML (``entry.make_videoio_files``), read back through
VideoCapture and FileStorage, the flagship chain with the YAML's values
(``sep_filter`` k5 through its plain version on a CPU tensor), and an FFV1
AVI out through VideoWriter; held to the same chain through opencv_tpu (its
VideoWriter, VideoCapture and FileStorage, and the flagship through
``_jax_chain``'s ops): in.avi, params.yml and out.avi byte-equal, the
decoded frames equal, the output within the flagship slice's bound (at most
1 grey level, on at most 0.1% of the pixels)."""

import os

import numpy as np
import pytest
import torch

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch import highgui
from opencv_tpu_torch.core.dispatch import reset_tier_stats, tier_stats
from torch_threads import _one_torch_thread  # noqa: F401

SHAPE = (2, 108, 192, 3)


def _read_all(cap):
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(np.asarray(f))
    return out


def _jax_files(d, shape):
    """make_videoio_files through the JAX package's VideoWriter and
    FileStorage."""
    N, H, W, _ = shape
    wr = jcv.VideoWriter(os.path.join(d, "in.avi"), jcv.VideoWriter_fourcc(*"HFYU"),
                         E.VIDEOIO_FPS, (W, H))
    for f in E.make_motion_video(shape)[0]:
        wr.write(f)
    wr.release()
    fs = jcv.FileStorage(os.path.join(d, "params.yml"), jcv.FILE_STORAGE_WRITE)
    fs.write("ksize", np.array([[5, 5]], np.int32))
    fs.write("dsize", np.array([[W // 2, H // 2]], np.int32))
    fs.write("M", jcv.getRotationMatrix2D((W / 4, H / 4), 15.0, 0.9))
    fs.write("fourcc_out", "FFV1")
    fs.write("fps", E.VIDEOIO_FPS)
    fs.release()


def _jax_forward_videoio(d):
    """forward_videoio's steps through the JAX package."""
    fs = jcv.FileStorage(os.path.join(d, "params.yml"), jcv.FILE_STORAGE_READ)
    ksize = tuple(int(v) for v in fs.getNode("ksize").mat().ravel())
    dsize = tuple(int(v) for v in fs.getNode("dsize").mat().ravel())
    M = fs.getNode("M").mat()
    decoded = np.stack(_read_all(jcv.VideoCapture(os.path.join(d, "in.avi"))))
    g = jcv.cvtColor(decoded, jcv.COLOR_BGR2GRAY)
    b = jcv.GaussianBlur(g, ksize, 0)
    out = np.asarray(jcv.warpAffine(jcv.resize(b, dsize), M, dsize))[..., 0]
    wr = jcv.VideoWriter(os.path.join(d, "out.avi"),
                         jcv.VideoWriter_fourcc(*fs.getNode("fourcc_out").string()),
                         fs.getNode("fps").real(), dsize, isColor=False)
    for o in out:
        wr.write(o)
    wr.release()
    return decoded, out


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_forward_videoio_against_opencv_tpu(tmp_path):
    t_dir, j_dir = tmp_path / "t", tmp_path / "j"
    t_dir.mkdir(), j_dir.mkdir()
    in_path, params_path = E.make_videoio_files(t_dir, SHAPE)
    assert (in_path, params_path) == (str(t_dir / "in.avi"), str(t_dir / "params.yml"))
    _jax_files(str(j_dir), SHAPE)
    for name in ("in.avi", "params.yml"):
        assert _bytes(t_dir / name) == _bytes(j_dir / name), name
    times = {}
    highgui.destroyAllWindows()
    reset_tier_stats()
    out = E.forward_videoio(in_path, params_path, str(t_dir / "out.avi"), "cpu", times)
    assert tier_stats() == {"tier.sep_filter_u8.plain": 1}
    assert tuple(times) == E.VIDEOIO_STAGES
    frames = E.make_motion_video(SHAPE)[0]
    want_dec, want = _jax_forward_videoio(str(j_dir))
    np.testing.assert_array_equal(out["decoded"], frames)
    np.testing.assert_array_equal(out["decoded"], want_dec)
    prm = out["params"]
    assert prm["ksize"] == (5, 5) and prm["dsize"] == (96, 54)
    assert prm["fourcc_out"] == "FFV1" and prm["fps"] == E.VIDEOIO_FPS
    M = tcv.getRotationMatrix2D((192 / 4, 108 / 4), 15.0, 0.9)
    assert prm["M"].dtype == np.float64 and prm["M"].tobytes() == M.tobytes()
    y = out["out"]
    assert y.device.type == "cpu" and y.shape == (2, 54, 96, 1) and y.dtype == torch.uint8
    assert torch.equal(y, E.forward(torch.from_numpy(frames)))
    np.testing.assert_array_equal(out["host"], y[..., 0].numpy())
    d = np.abs(out["host"].astype(int) - want.astype(int))
    assert d.max() <= 1 and np.count_nonzero(d) <= d.size // 1000
    # out.avi: the JAX package's writer on the port's output gives the same
    # bytes, and so does its whole chain (at this size the outputs are equal)
    wr = jcv.VideoWriter(str(j_dir / "port_out.avi"), jcv.VideoWriter_fourcc(*"FFV1"),
                         E.VIDEOIO_FPS, (96, 54), isColor=False)
    for o in out["host"]:
        wr.write(o)
    wr.release()
    assert _bytes(t_dir / "out.avi") == _bytes(j_dir / "port_out.avi")
    assert _bytes(t_dir / "out.avi") == _bytes(j_dir / "out.avi")
    back = _read_all(tcv.VideoCapture(str(t_dir / "out.avi")))
    assert len(back) == 2
    for f, o in zip(back, out["host"]):
        assert f.shape == (54, 96, 3)
        for c in range(3):
            np.testing.assert_array_equal(f[..., c], o)
    np.testing.assert_array_equal(highgui._windows["videoio"], out["host"][-1])
    highgui.destroyAllWindows()


def test_forward_videoio_checks_the_file_against_the_yaml(tmp_path):
    in_path, params_path = E.make_videoio_files(tmp_path, SHAPE)
    fs = tcv.FileStorage(params_path, tcv.FILE_STORAGE_READ)
    bad = str(tmp_path / "bad.yml")
    for key, value in (("fps", 30.0), ("dsize", np.array([[100, 54]], np.int32))):
        w = tcv.FileStorage(bad, tcv.FILE_STORAGE_WRITE)
        for k in ("ksize", "dsize", "M"):
            w.write(k, fs.getNode(k).mat())
        w.write("fourcc_out", "FFV1")
        w.write("fps", E.VIDEOIO_FPS)
        w.write(key, value)
        w.release()
        with pytest.raises(ValueError):
            E.forward_videoio(in_path, bad, str(tmp_path / "o.avi"), "cpu")
    with pytest.raises(ValueError):
        E.forward_videoio(str(tmp_path / "missing.avi"), params_path, str(tmp_path / "o.avi"),
                          "cpu")


def test_forward_videoio_raises_without_a_card(tmp_path):
    """No step carries on on the CPU when the card is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    in_path, params_path = E.make_videoio_files(tmp_path, (1, 16, 32, 3))
    with pytest.raises((RuntimeError, AssertionError)):
        E.forward_videoio(in_path, params_path, str(tmp_path / "o.avi"))
    assert not os.path.exists(tmp_path / "o.avi")
    assert E.SHAPE_VIDEOIO == (8, 1080, 1920, 3)
