"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each library is compiled at first use from `csrc/` into
`software_rasterizer_tpu_torch/_build/`, named by a hash of its sources
and flags, so an edit rebuilds and an unchanged tree reuses the file.
The sources export plain C functions; nothing includes PyTorch's headers,
which keeps a build to seconds. A failed build raises with nvcc's output.
Each library has its own lock, so threads can build several at once, and
its own lock file in `_build/`, so of several processes (the ranks of a
sharded render) one builds and the others wait and load. `build_once`
also serves the host library's g++ build (`utils/native.py`); its C++
source is not a header, so it is not in the CUDA libraries' hash.
`BUILDS` counts the libraries this process built; loading a library the
first time is the `srt.load_library` span (`utils/profiling.span`).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Callable, Dict, List, Sequence

from software_rasterizer_tpu_torch.utils.profiling import span

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
# libraries this process built (nvcc's and g++'s), by the lock file's
# name: the library's own
BUILDS: Dict[str, int] = {}


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


def build_once(out: pathlib.Path, lock: pathlib.Path,
               build: Callable[[str], None]) -> bool:
    """Make `out` by `build(tmp)`, which writes a temporary file in
    `out`'s directory that is then moved into place, unless `out` exists.
    An exclusive `flock` on the file `lock` serializes the check and the
    build across processes; the lock goes with its process, so a build
    cut off leaves none behind. Returns True when this call built `out`,
    and then counts it in `BUILDS` under `lock`'s stem."""
    if out.exists():
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(lock, "a") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if out.exists():
                return False
            fd, tmp = tempfile.mkstemp(suffix=out.suffix, dir=out.parent)
            os.close(fd)
            try:
                build(tmp)
            except BaseException:
                os.unlink(tmp)
                raise
            os.replace(tmp, out)
            with _LOCK:
                BUILDS[lock.stem] = BUILDS.get(lock.stem, 0) + 1
            return True
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def load_library(name: str, sources: List[str]) -> ctypes.CDLL:
    """Compile csrc/<sources> into _build/lib<name>-<hash>.so (once) and
    load it. Raises RuntimeError with nvcc's output if the build fails.
    A library not loaded yet is loaded (and built) in an
    `srt.load_library` span; a loaded one is returned at once."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LIBS:
            return _LIBS[name]
        with span("srt.load_library"):
            srcs = [CSRC_DIR / s for s in sources]
            out = BUILD_DIR / f"lib{name}-{_digest(srcs)}.so"

            def nvcc(tmp: str) -> None:
                cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                BUILD_LOGS[name] = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}) building {name}:\n"
                        f"{' '.join(cmd)}\n{BUILD_LOGS[name]}")

            build_once(out, BUILD_DIR / f"{name}.lock", nvcc)
            lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
        return lib


def library_path(name: str) -> pathlib.Path:
    """The file of the loaded library `name` (after `load_library`)."""
    return pathlib.Path(_LIBS[name]._name)
