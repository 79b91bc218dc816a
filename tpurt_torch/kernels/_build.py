"""Build and load the port's CUDA kernels (nvcc + ctypes).

The sources in ``csrc/`` compile at first use, one nvcc per source,
all started together, and link into one shared library with a plain C
interface, cached in ``_build/`` under a name keyed by a hash of the
sources and flags, so an edited source rebuilds. Nothing here runs at
import time: the CPU tests import every module.

Flags: sm_90a, -O3, and ``--fmad=false``. FMA contraction would move the
results away from tpurt's expression order, and fast-math would also
flush denormals (material ids stored as int bit patterns are denormal
floats). So there is no ``--use_fast_math``, no ``-ftz=true``, and
division and sqrt stay IEEE.

Each C entry point returns ``cudaGetLastError()``; ``launch`` raises on
anything but 0. ``LAUNCHES`` counts successful launches per kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry point -> argument kinds: p = device pointer, i = int. Every
# entry point takes the CUDA stream last and returns a cudaError_t.
SIGNATURES = {
    "tt_slab_step": "p" * 12 + "i",
    "tt_leaf_phase": "p" * 15 + "i",
    "tt_traverse_nearest": "pii" + "p" * 9 + "i",
    "tt_nearest_tri_small": "p" * 6 + "i" + "p" * 6 + "i",
    "tt_vmemloop": "p" * 9 + "iii",
}

# kernel name -> launches since the last reset (counted by the wrappers)
LAUNCHES = {"slab_step": 0, "leaf_phase": 0, "traverse_nearest": 0,
            "nearest_tri_small": 0, "vmemloop": 0}

_LOADED: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpurt_torch_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the library if it is not built yet. Returns
    {"path", "seconds", "log"}; ``log`` holds ptxas's register report."""
    so = library_path()
    if so.exists():
        return {"path": str(so), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for obj, proc in jobs:
        _, err = proc.communicate(timeout=900)
        log.append(err)
        if proc.returncode != 0:
            failed.append(f"{obj.name} ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = so.with_name(f"{so.name}.tmp.{os.getpid()}")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                          *(str(obj) for obj, _ in jobs)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, so)
    for obj, _ in jobs:
        obj.unlink()
    return {"path": str(so), "seconds": time.perf_counter() - t0,
            "log": "".join(log)}


def load():
    """The loaded ctypes library, building it first if needed. Loaded
    once per process: the sources are hashed only on the first call."""
    if "lib" not in _LOADED:
        lib = ctypes.CDLL(build()["path"])
        for name, kinds in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p if k == "p" else ctypes.c_int
                           for k in kinds] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.tt_error_string.argtypes = [ctypes.c_int]
        lib.tt_error_string.restype = ctypes.c_char_p
        _LOADED["lib"] = lib
    return _LOADED["lib"]


def cuda_device(kernel: str, t):
    """t's device, which must be a CUDA device: a wrapper runs its plain
    version only for CPU tensors and never falls back."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: tensors on {t.device}; the kernel "
                         "takes CUDA tensors, the plain version CPU ones")
    return t.device


def check(name: str, t, shape, dtype, device) -> None:
    """Raise unless tensor t is a contiguous ``dtype`` tensor of ``shape``
    on ``device``."""
    if not torch.is_tensor(t):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def launch(entry: str, device, *args) -> None:
    """Call C entry point ``entry`` on ``device``'s current stream with
    tensors passed as device pointers and ints as ints; raise if the
    launch reports an error."""
    fn = getattr(load(), entry)
    cargs = [a.data_ptr() if torch.is_tensor(a) else int(a) for a in args]
    with torch.cuda.device(device):
        rc = fn(*cargs, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = load().tt_error_string(rc).decode()
        raise RuntimeError(f"{entry}: CUDA error {rc} ({msg})")
