"""Build the hand-written CUDA kernels under ``csrc/`` at first use.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain C
interface, which the kernels' wrappers load with ``ctypes``. The
library goes into ``deeplearningexamples_tpu_torch/_build/`` under a name that
carries a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "load", "nvcc"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc() -> str:
    """Path of nvcc under ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``."""
    roots = [os.environ["CUDA_HOME"]] if os.environ.get("CUDA_HOME") else []
    roots.append("/usr/local/cuda")
    for root in roots:
        path = Path(root) / "bin" / "nvcc"
        if path.is_file():
            return str(path)
    raise RuntimeError(
        f"nvcc not found under {roots}: the CUDA kernels cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libdlx_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library of the same sources exists.
    Raises ``RuntimeError`` with nvcc's stderr when a step fails."""
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    tmp = out.with_name(f"{tag}.so.tmp")
    try:
        failed = []
        for _, cmd, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        cmd = [nvcc(), "-shared", "-o", str(tmp), *(str(o) for o, _, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build loads a whole file
    finally:
        for obj, _, proc in jobs:
            proc.kill()  # a no-op for a process that has ended
            proc.wait()
            obj.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib
