"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface that ``ctypes`` loads.  The library lives under
``build/kernels/<hash>/`` at the repository root, keyed by a hash of the
sources and flags, so the first call in a fresh checkout builds it and
later calls reuse it.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libemp_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Constants a source is compiled with (-D flags), where Python code needs
# the same values: the B7 backward's sum order (csrc/triplane_sample.cu),
# which ops.kernels.triplane_sample_bwd_reference replays on the host.  A
# cell with more than EMP_TB_LIGHT entries is summed in chunks of
# EMP_TB_CHUNK entries from its list's start, each by EMP_TB_LANES lanes
# and a tree over them.
DEFINES = {
    "triplane_sample.cu": {"EMP_TB_LIGHT": 32, "EMP_TB_LANES": 256,
                           "EMP_TB_CHUNK": 1024},
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# C entry points: name -> argtypes (all return an int: a cudaError_t, or
# for emp_sm_count the card's SM count)
SIGNATURES = {
    "emp_convnext_block": [_P] * 12 + [_I] * 4 + [_P],
    "emp_epilogue_fwd": [_P] * 11 + [_I] * 4 + [_P],
    "emp_sm_count": [],
    "emp_epilogue_bwd": [_P] * 23 + [_I] * 5 + [_P],
    "emp_attention_fwd": [_P] * 5 + [_I, _I, _I, _I, _F, _P],
    "emp_attention_bwd": [_P] * 10 + [_I, _I, _I, _I, _F, _P],
    "emp_attention_config": [_I, _P],
    "emp_ln_dense": [_P] * 7 + [_I, _I, _I, _F, _P],
    "emp_gelu_dense": [_P] * 5 + [_I, _I, _I, _P],
    "emp_dense_config": [_P],
    "emp_triplane_sample_fwd": [_P] * 3 + [_I] * 4 + [_P],
    "emp_triplane_sample_bwd": [_P] * 3 + [_LL, _P] + [_I] * 4 + [_P],
    "emp_triplane_bwd_scratch_words": [_I] * 4 + [_P],
    "emp_finite_mlp": [_P] * 6 + [_I, _I, _P],
    "emp_convnext_block_int8": [_P] * 16 + [_I] * 4 + [_P],
    "emp_int8_gemm": [_P] * 3 + [_I] * 4 + [_P],
    "emp_cam_gather_fwd": [_P] * 4 + [_I] * 5 + [_P],
    "emp_cam_gather_bwd": [_P] * 5 + [_I] * 5 + [_P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build this process ran, if any


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needs the CUDA toolkit)")
    return path


def _defines(src: Path) -> list:
    return [f"-D{k}={v}" for k, v in DEFINES.get(src.name, {}).items()]


def build_dir() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted((k, sorted(v.items()))
                         for k, v in DEFINES.items())).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet;
    return the library's path."""
    global build_seconds
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    t0 = time.perf_counter()
    nvcc = _nvcc()
    cu, _ = _sources()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    try:
        procs = []
        for src in cu:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *_defines(src), "-I", str(CSRC),
                   "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, objs, failed = [], [], []
        for src, obj, p in procs:
            text, _ = p.communicate()
            log.append(f"== {src.name} (rc {p.returncode})\n{text}")
            objs.append(str(obj))
            if p.returncode:
                failed.append(src.name)
        (tmp / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(log)[-8000:]
            )
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIB_NAME), *objs],
            capture_output=True, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
        try:
            tmp.rename(out)
        except OSError:  # another process finished the same build first
            if not lib.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib


def build_log() -> str:
    """The compiler's output (``-Xptxas -v`` register and shared-memory
    use per kernel) of the current build, or '' before a build."""
    p = build_dir() / "build.log"
    return p.read_text() if p.exists() else ""


def load():
    """The loaded kernel library (built on first use), with ``argtypes``
    and ``restype`` declared for every entry point."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
