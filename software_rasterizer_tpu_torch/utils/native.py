"""ctypes bindings for the native host library (csrc/srt_native.cpp): the
reference BVH build and the OBJ scan in C++, the port of the JAX
package's utils/native.py.

The source is a byte-identical copy of the JAX package's
native/srt_native.cpp, kept in the package so that it stands alone. It is
compiled at first use with g++ and the flags of native/Makefile into
`_build/libsrt_native-<hash>.so`, named by a hash of the compiler, the
flags and the source, through `cuda_build.build_once` (whose `flock`
serializes builds across processes). The same flags make the tree's
cumulative `area` bit-identical to the JAX package's default (native)
build. There is no quiet fallback: a failed build raises with the
compiler's output, and callers that want the pure-Python paths ask for
them (`use_native=False`).

`ctypes.CDLL` loads with RTLD_LOCAL, so the symbols stay apart from the
JAX package's copy of the library when both are loaded in one process.
"""

from __future__ import annotations

import ctypes
import hashlib
import pathlib
import subprocess
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from software_rasterizer_tpu_torch.utils.cuda_build import BUILD_DIR, CSRC_DIR, build_once

SOURCE = CSRC_DIR / "srt_native.cpp"
CXX = "g++"
# native/Makefile's CXXFLAGS and link flag
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
ABI = 2  # srt_abi_version() of the prototypes declared in `_declare`

_LOCK = threading.Lock()
_LIBS: Dict[Tuple[Optional[str], str], ctypes.CDLL] = {}


def library_file(cxx: str = CXX) -> pathlib.Path:
    """The library `build` makes with `cxx` from this tree's source."""
    h = hashlib.sha256(" ".join([cxx, *CXX_FLAGS]).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsrt_native-{h.hexdigest()[:16]}.so"


def build(cxx: str = CXX) -> pathlib.Path:
    """Compile csrc/srt_native.cpp with `cxx` (once; an existing file of
    the same hash is reused) and return its path. Raises RuntimeError with
    the compiler's output if the build fails or `cxx` cannot be run."""
    out = library_file(cxx)

    def compile_to(tmp: str) -> None:
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) building the native "
                               f"library:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")

    build_once(out, BUILD_DIR / "srt_native.lock", compile_to)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.srt_bvh_node_count.restype = ctypes.c_int32
    lib.srt_bvh_node_count.argtypes = [ctypes.c_int32]
    lib.srt_build_bvh.restype = ctypes.c_int32
    lib.srt_build_bvh.argtypes = [ctypes.c_int32] + [f32p] * 3 + [f32p] * 2 + [i32p] * 3 + [f32p]
    lib.srt_parse_obj_counts.restype = ctypes.c_int32
    lib.srt_parse_obj_counts.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32p]
    lib.srt_parse_obj.restype = ctypes.c_int32
    lib.srt_parse_obj.argtypes = [ctypes.c_char_p, ctypes.c_int64, f64p, f64p, f64p, i32p]


def load(path: Optional[str] = None, cxx: str = CXX) -> ctypes.CDLL:
    """Load (once) and return the native library: the file `path`, or,
    for None, this tree's source built with `cxx` (`build`). Raises
    RuntimeError if the build fails or the library's `srt_abi_version()`
    is not `ABI` (a stale library would be called through mismatched
    prototypes and return garbage with rc 0)."""
    key = (None if path is None else str(path), cxx)
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(build(cxx) if path is None else path))
        try:
            fn = lib.srt_abi_version
        except AttributeError:
            raise RuntimeError(f"{lib._name}: no srt_abi_version") from None
        fn.restype, fn.argtypes = ctypes.c_int32, []
        ver = int(fn())
        if ver != ABI:
            raise RuntimeError(f"{lib._name}: ABI version {ver}, expected {ABI}")
        _declare(lib)
        _LIBS[key] = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def build_bvh_native(bb_min: np.ndarray, bb_max: np.ndarray, areas: np.ndarray):
    """Native BVH build over (N,3) primitive boxes and (N,) areas; returns
    the FlatBVH field tuple (node_min, node_max, left, right, prim, area).
    Node order and boxes equal the Python builder's (`ops.bvh.build_bvh(
    use_native=False)`); `area` is summed in float32, the Python builder's
    in float64. Raises RuntimeError if the library is unavailable or the
    build reports an inconsistent tree."""
    lib = load()
    n = int(bb_min.shape[0])
    bb_min = np.ascontiguousarray(bb_min, np.float32)
    bb_max = np.ascontiguousarray(bb_max, np.float32)
    areas = np.ascontiguousarray(areas, np.float32)
    if bb_min.shape != (n, 3) or bb_max.shape != (n, 3) or areas.shape != (n,):
        raise ValueError(f"boxes {bb_min.shape} / {bb_max.shape} and areas "
                         f"{areas.shape} for {n} primitives")
    m = lib.srt_bvh_node_count(n)
    node_min = np.empty((m, 3), np.float32)
    node_max = np.empty((m, 3), np.float32)
    left = np.empty(m, np.int32)
    right = np.empty(m, np.int32)
    prim = np.empty(m, np.int32)
    area = np.empty(m, np.float32)
    rc = lib.srt_build_bvh(
        n, _fp(bb_min), _fp(bb_max), _fp(areas),
        _fp(node_min), _fp(node_max), _ip(left), _ip(right), _ip(prim), _fp(area),
    )
    if rc != 0:
        raise RuntimeError(f"srt_build_bvh returned {rc} for {n} primitives")
    return node_min, node_max, left, right, prim, area


def parse_obj_native(text: str):
    """Native OBJ scan: (positions (P,3) f64, normals (N,3) f64, uvs (T,2)
    f64, corners (C,3) i32 of (v, vt, vn) with -1 absent), the outputs of
    `obj_loader._scan_obj_python`. f64 so that the normalization and
    V-flip downstream match the Python scan bit for bit before the final
    f32 cast. Raises RuntimeError if the library is unavailable."""
    lib = load()
    raw = text.encode("utf-8", errors="replace")
    counts = np.zeros(4, np.int32)
    lib.srt_parse_obj_counts(raw, len(raw), _ip(counts))
    np_, nn, nt, nc = (int(x) for x in counts)
    pos = np.empty((np_, 3), np.float64)
    nrm = np.empty((nn, 3), np.float64)
    uv = np.empty((nt, 2), np.float64)
    corners = np.empty((nc, 3), np.int32)
    rc = lib.srt_parse_obj(raw, len(raw), _dp(pos), _dp(nrm), _dp(uv), _ip(corners))
    if rc != 0:
        raise RuntimeError(f"srt_parse_obj returned {rc}")
    return pos, nrm, uv, corners
