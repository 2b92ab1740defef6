"""Build the hand-written CUDA kernels under ``csrc/`` at first use.

The sources make two shared libraries with a plain C interface, which the
wrappers load with ``ctypes``: ``kernels`` (K1-K6, the TPU kernels' ports)
and ``dataplane`` (the card's JPEG decode through nvJPEG and the resample
kernel, linked with ``-lnvjpeg``), so that K1-K6 build and load without
nvJPEG. Each ``.cu`` file is compiled by its own ``nvcc`` process, all
started together. A library goes into ``deeplearningexamples_tpu_torch/_build/``
under a name that carries a hash of its sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. ``build_host``
builds the host data plane (``native/dataplane.cc``) with g++ the same way.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["HOST_FLAGS", "LIBRARIES", "NVCC_FLAGS", "build", "build_host",
           "load", "nvcc"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# each library's own .cu files and link flags; "kernels" takes every .cu
# file that no other library names
LIBRARIES = {
    "kernels": ((), ()),
    "dataplane": (("nvjpeg_decode.cu", "resample_normalize.cu"),
                  ("-lnvjpeg",)),
}

# the host data plane's g++ flags (deeplearningexamples_tpu/native/Makefile)
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


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


def _sources(name: str) -> list[Path]:
    """The library's ``.cu`` files."""
    named, _ = LIBRARIES[name]
    if named:
        return [CSRC / n for n in named]
    others = {n for lib, (ns, _) in LIBRARIES.items() if lib != name
              for n in ns}
    return [s for s in sorted(CSRC.glob("*.cu")) if s.name not in others]


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LIBRARIES[name][1]).encode())
    for src in _sources(name) + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libdlx_{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str) -> list[Path]:
    """Compile the named libraries (all of them when none is named) unless
    a library of the same sources exists, every ``.cu`` file at once.
    Raises ``RuntimeError`` with nvcc's stderr when a step fails."""
    outs = [(name, _library_path(name)) for name in names or LIBRARIES]
    todo = [(name, out) for name, out in outs if not out.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, tmps = [], []
    try:
        for name, out in todo:
            tag = f"{out.stem}.{os.getpid()}"
            for src in _sources(name):
                obj = BUILD_DIR / f"{tag}.{src.stem}.o"
                cmd = [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                jobs.append((name, obj, cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
        failed = []
        for _, _, cmd, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for name, out in todo:
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.so.tmp")
            tmps.append(tmp)
            cmd = [nvcc(), "-shared", "-o", str(tmp),
                   *(str(o) for n, o, _, _ in jobs if n == name),
                   *LIBRARIES[name][1]]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed:\n{' '.join(cmd)}\n{res.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent build loads a whole file
    finally:
        for _, obj, _, proc in jobs:
            proc.kill()  # a no-op for a process that has ended
            proc.wait()
            obj.unlink(missing_ok=True)
        for tmp in tmps:
            tmp.unlink(missing_ok=True)
    return [out for _, out in outs]


def load(name: str = "kernels") -> ctypes.CDLL:
    """The named shared library, built on the first call."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build(name)[0]))
        return _libs[name]


def build_host(src: Path, libs: tuple[str, ...]) -> Path:
    """Compile the C++ file ``src`` with g++ (``HOST_FLAGS``, linked with
    ``libs``) into a shared library in ``_build/``, unless one of the same
    source and flags exists. Raises ``RuntimeError`` naming what is missing:
    g++, a header, or a library."""
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError(f"g++ not found on PATH: {src.name} cannot be built")
    digest = hashlib.sha256(" ".join(HOST_FLAGS + libs).encode())
    digest.update(src.read_bytes())
    out = BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.so.tmp")
    cmd = [compiler, *HOST_FLAGS, str(src), "-shared", "-o", str(tmp), *libs]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            missing = [line.strip() for line in res.stderr.splitlines()
                       if "No such file" in line or "cannot find" in line]
            raise RuntimeError(
                f"building {src.name} failed"
                + (f", missing: {'; '.join(missing)}" if missing else "")
                + f"\n{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out
