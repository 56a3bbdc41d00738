"""Build and load the CUDA kernels in `csrc/`.

At first CUDA use, every `csrc/*.cu` is compiled by `nvcc` for Hopper
(sm_90a) into one shared library with a plain C interface under
`build/toyni_tpu_torch/` at the repository root, named by a hash of the
sources and flags, and loaded with ctypes. Each C entry point takes device
pointers and the CUDA stream as `void*`, launches on that stream, and
returns `cudaGetLastError()`; the Python wrappers raise when it is not 0.

Nothing here runs at import time: a machine without `nvcc` or a card can
import the package and use the plain CPU versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "toyni_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
# C signatures: every pointer and the stream are void*, sizes long long
SIGNATURES = {
    "toyni_ntt_forward": (_P, _P, _P, _LL, ctypes.c_int, _P),
    "toyni_sha256_salted_leaves": (_P, _P, _P, _LL, _P),
    "toyni_sha256_unsalted_leaves": (_P, _P, _LL, _P),
    "toyni_sha256_nodes": (_P, _P, _P, _LL, _P),
}

_LIB = None
# what the last build in this process did: seconds and the compiler's output
BUILD_INFO: dict = {}


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtoyni_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(path: Path) -> None:
    """Compile every .cu in csrc/ into `path` (written atomically)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, path)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, log=res.stdout + res.stderr)


def load() -> ctypes.CDLL:
    """The kernel library, built first if this source hash has no build."""
    global _LIB
    if _LIB is None:
        path = library_path()
        if not path.exists():
            build(path)
        lib = ctypes.CDLL(str(path))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(rc: int, what: str) -> None:
    """Raise on a non-zero CUDA error code from a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
