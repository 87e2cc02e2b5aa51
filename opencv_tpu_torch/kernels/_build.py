"""Build and load the hand-written CUDA kernels (``opencv_tpu_torch/csrc``).

At the first launch, one ``nvcc`` per ``csrc/*.cu`` compiles it to an object
file, all of them started together, and a last ``nvcc -shared`` links the
objects into one shared library with a plain C interface, which is loaded
with ``ctypes``.  The library lands in ``opencv_tpu_torch/_build/`` under a
name that carries a hash of the sources and flags, so an edit rebuilds and
an unchanged tree reuses the file.  It is written to a temporary name and
moved into place with ``os.replace``, so concurrent processes never load a
half-written file.  Beside it, ``<name>.ptxas.txt`` keeps what ``ptxas -v``
said of each kernel (registers, stack, spills); :func:`ptxas_report` reads
it.

Nothing here runs for CPU tensors: importing the package needs no CUDA
toolkit.  A missing ``nvcc``, a failed build or a launch that returns a CUDA
error raises; there is no fallback.

ctypes notes: every pointer and the stream are declared ``c_void_p`` (an
undeclared Python int is passed as a 32-bit C int and cuts the pointer),
pointers come from ``Tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["NVCC_FLAGS", "Kernel", "library", "parse_ptxas", "ptxas_report", "stream_of"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _library_path() -> Path:
    sources, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libopencv_tpu_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list) -> str:
    """Run the commands concurrently; return their standard error, or raise
    with the output of every one that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)) for cmd in cmds]
    errors, logs = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return "".join(logs)


def _build(so: Path) -> None:
    sources, _ = _sources()
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    nvcc = _nvcc()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c", "-o",
                         str(obj), str(src)] for src, obj in zip(sources, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        so.with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, so)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this tree has no copy."""
    global _lib
    with _lock:
        if _lib is None:
            so = _library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.opencv_tpu_torch_error_string.argtypes = [ctypes.c_int]
            lib.opencv_tpu_torch_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def ptxas_report() -> dict:
    """{mangled kernel name: {"registers", "stack", "spill_stores",
    "spill_loads"}} from what ``ptxas -v`` said when the loaded library was
    built (bytes, but registers)."""
    library()
    return parse_ptxas(_library_path().with_suffix(".ptxas.txt").read_text())


def parse_ptxas(text: str) -> dict:
    """The kernels of a ``ptxas -v`` log, as :func:`ptxas_report` gives
    them; the lines of functions that are not kernels are skipped."""
    report, cur, entry = {}, None, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            if "Compiling entry" in line:
                entry = report.setdefault(m.group(1), {})
            cur = report.get(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            entry["registers"] = int(m.group(1))
    return report


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


class Kernel:
    """One C entry point of the library, with its launch count.

    ``launches`` goes up by one for every successful launch, and nowhere
    else, so a run can show that its main path went through the kernel.
    An entry with several routes (kernels behind one entry point) also
    counts each successful launch under its route, in ``routes``.
    """

    def __init__(self, symbol: str, argtypes: list, routes: tuple = ()):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.routes = dict.fromkeys(routes, 0)
        self._fn = None

    def reset(self) -> None:
        """Set the launch count and the route counts to 0."""
        self.launches = 0
        self.routes = dict.fromkeys(self.routes, 0)

    def __call__(self, device: torch.device, *args, route: str | None = None) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            err = self._fn(*args)
        if err != 0:
            msg = library().opencv_tpu_torch_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1
        if route is not None:
            self.routes[route] += 1
