"""Build the port's CUDA kernels with nvcc and load them with ctypes.

At first use, every ``gcm_filters_tpu_torch/csrc/*.cu`` source is compiled
into a shared library with a plain C interface under ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``). A library is named after the
hash of its source and of the compiler flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. All missing libraries compile at
once, one ``nvcc`` process per source. A failed build raises with nvcc's
output; there is no fallback.

The sources include no PyTorch header: pointers and the stream cross as
``ctypes.c_void_p`` (the wrappers set ``argtypes``), which keeps a build to
seconds instead of minutes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

from ...utils.telemetry import setup_span

SRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# No --use_fast_math: it breaks the NaN test in nan_to_num and the 0*x NaN
# poison the kernels rely on.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # nvcc's output (registers, spills) per source built here


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in the CUDA "
        "toolkit's default prefix); the port's CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(SRC_DIR.joinpath(f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def sources() -> list:
    """Names of all kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet, all
    at once, and return each library's path. Raises if any build fails."""
    names = list(sources() if names is None else names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[n] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on csrc/{n}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[n])  # atomic: a reader never sees half a library
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    with _lock:
        if name not in _loaded:
            with setup_span("gft.setup.kernels") as s:
                s.counts["builds"] = int(not library_path(name).exists())
                _loaded[name] = ctypes.CDLL(str(build([name])[name]))
        return _loaded[name]
