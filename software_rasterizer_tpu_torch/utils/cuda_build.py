"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each library is compiled at first use from `csrc/` into
`software_rasterizer_tpu_torch/_build/`, named by a hash of its sources
and flags, so an edit rebuilds and an unchanged tree reuses the file.
The sources export plain C functions; nothing includes PyTorch's headers,
which keeps a build to seconds. A failed build raises with nvcc's output.
Each library has its own lock, so threads can build several at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Sequence

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"

# -fmad=false and no --use_fast_math: every multiply and add rounds on
# its own, as in the plain PyTorch versions the kernels are held against
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]

_LOCK = threading.Lock()
_NAME_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register and spill counts) per built library
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found ($CUDA_HOME/bin, /usr/local/cuda/bin, PATH): "
            "the CUDA kernels cannot be built")
    return found


def _digest(sources: Sequence[pathlib.Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    for path in list(sources) + headers:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str, sources: List[str]) -> ctypes.CDLL:
    """Compile csrc/<sources> into _build/lib<name>-<hash>.so (once) and
    load it. Raises RuntimeError with nvcc's output if the build fails."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LIBS:
            return _LIBS[name]
        srcs = [CSRC_DIR / s for s in sources]
        out = BUILD_DIR / f"lib{name}-{_digest(srcs)}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            BUILD_LOGS[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {name}:\n"
                    f"{' '.join(cmd)}\n{BUILD_LOGS[name]}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
        return lib


def library_path(name: str) -> pathlib.Path:
    """The file of the loaded library `name` (after `load_library`)."""
    return pathlib.Path(_LIBS[name]._name)
