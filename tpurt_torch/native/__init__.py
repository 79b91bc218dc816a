"""Native (C++) host-runtime components, loaded via ctypes.

Copy of tpurt/native (this file, sah.cpp, objparse.cpp), unchanged but
for where it builds: the .so files go to tpurt_torch/native/_build/.

The compute path is JAX/XLA; the HOST runtime around it goes native
where it is measurably hot. First resident: the binned-SAH split
(`sah.cpp`), the single hot spot of every BVH build (the NumPy
`_sah_partition` was 12.7 s of a 16.6 s blob-subdiv-6 scene build —
33.5k calls across the binary tree and both packet layouts).

The .so is compiled LAZILY with g++ on first use and cached in _build/
beside this file; every failure (no g++, sandboxed build dir, bad load) falls
back silently to the NumPy implementation — the native path is an
accelerator, never a dependency. `TPURT_NATIVE=0` disables it outright.
The port is bit-exact by construction (see sah.cpp's header) and
pinned by tests/test_native_sah.py + the golden images.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_BUILD = _DIR / "_build"

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_LL = ctypes.c_longlong
_PLL = ctypes.POINTER(ctypes.c_longlong)

_libs: dict = {}


def _load(name: str):
    """Lazy-compile + load tpurt_torch/native/<name>.cpp as
    _build/_<name>.so; None on any failure (no g++, sandbox,
    TPURT_NATIVE=0)."""
    if name in _libs:
        return _libs[name]
    lib = None
    if os.environ.get("TPURT_NATIVE", "1") != "0":
        src = _DIR / f"{name}.cpp"
        so = _BUILD / f"_{name}.so"
        try:
            if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
                _BUILD.mkdir(exist_ok=True)
                # PID-suffixed temp + atomic rename: concurrent
                # first-use builds each publish a whole file
                tmp = _BUILD / f"_{name}.so.tmp.{os.getpid()}"
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp),
                     str(src)],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, so)  # atomic publish
            lib = ctypes.CDLL(str(so))
            _SIGS[name](lib)
        except Exception:
            lib = None
    _libs[name] = lib
    return lib


def _sig_sah(lib):
    fn = lib.sah_partition
    fn.restype = _LL
    # ndpointer argtypes: ndarrays pass directly (the former per-call
    # .ctypes.data_as chain was ~40% of native build time)
    fn.argtypes = [_F32, _F32, _F32, _I64, _LL, _LL, _I64, _I64, _PLL]


def _sig_objparse(lib):
    buf = ctypes.c_char_p
    lib.obj_count.restype = _LL
    lib.obj_count.argtypes = [buf, _LL, _PLL, _PLL, _PLL]
    lib.obj_parse.restype = _LL
    lib.obj_parse.argtypes = [buf, _LL, _F64, _F64, _I64, _I64, _PLL]


_SIGS = {"sah": _sig_sah, "objparse": _sig_objparse}


def make_partitioner(tlo, thi, centroid, sah_bins):
    """Prebound native partitioner for one build, or None if unavailable.

    The returned callable(idx) -> (left, right, axis) is bit-identical
    to the NumPy _sah_partition (tested). Pointer conversion for the
    (fixed-per-build) geometry arrays happens ONCE here: per-call ctypes
    casts were ~40% of the native build time across the ~33k calls of a
    subdiv-6 build."""
    lib = _load("sah")
    if lib is None:
        return None
    tlo = np.ascontiguousarray(tlo, np.float32)
    thi = np.ascontiguousarray(thi, np.float32)
    centroid = np.ascontiguousarray(centroid, np.float32)
    bins = ctypes.c_longlong(sah_bins)
    fn = lib.sah_partition
    empty = np.empty
    c_longlong, byref = ctypes.c_longlong, ctypes.byref

    def partition(idx):
        idx = np.ascontiguousarray(idx, np.int64)
        n = idx.shape[0]
        out_l = empty(n, np.int64)
        out_r = empty(n, np.int64)
        nleft = c_longlong(0)
        axis = fn(tlo, thi, centroid, idx, c_longlong(n),
                  bins, out_l, out_r, byref(nleft))
        k = nleft.value
        return out_l[:k], out_r[: n - k], int(axis)

    return partition


def sah_partition(idx, tlo, thi, centroid, sah_bins):
    """One-shot native split (tests); None if unavailable."""
    part = make_partitioner(tlo, thi, centroid, sah_bins)
    return None if part is None else part(idx)


def available(name: str = "sah") -> bool:
    return _load(name) is not None


def obj_parse(data: bytes):
    """Native OBJ parse: (verts f64 (V,3), norms f64 (N,3), faces i64
    (T,3), face_vn i64 (T,3) with -1 rows, all_vn bool) — or None to
    signal fallback to the pure-Python parser (unavailable library OR
    any record the native twin does not replicate exactly; the Python
    path then also reproduces the original error behavior)."""
    lib = _load("objparse")
    if lib is None:
        return None
    n = len(data)
    nv = ctypes.c_longlong(0)
    nn = ctypes.c_longlong(0)
    nt = ctypes.c_longlong(0)
    if lib.obj_count(data, _LL(n), ctypes.byref(nv), ctypes.byref(nn),
                     ctypes.byref(nt)) != 0:
        return None
    verts = np.empty((max(nv.value, 1), 3), np.float64)
    norms = np.empty((max(nn.value, 1), 3), np.float64)
    faces = np.empty((max(nt.value, 1), 3), np.int64)
    face_vn = np.empty((max(nt.value, 1), 3), np.int64)
    all_vn = ctypes.c_longlong(0)
    rc = lib.obj_parse(data, _LL(n), verts, norms, faces, face_vn,
                       ctypes.byref(all_vn))
    if rc != 0:
        return None
    return (verts[: nv.value], norms[: nn.value], faces[: nt.value],
            face_vn[: nt.value], bool(all_vn.value))
