"""Build and load the port's hand-written CUDA kernels.

The sources under ``ops/csrc/`` expose plain C entry points, so they build
with ``nvcc`` alone (no PyTorch headers) into shared libraries that
``ctypes`` loads.  Each source builds in its own ``nvcc`` process, all
started together, into a library of its own under
``build/poseidon_tpu_torch/`` at the repository root, keyed by a hash of
the sources and flags: a fresh checkout builds everything from its own
sources and a second use in the same checkout reuses the build.

There is no fallback: a build or a load that fails raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from types import SimpleNamespace

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("fused_ladder.cu", "tiled_iteration.cu", "global_update.cu",
            "coarse_disaggregate.cu")
_HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# Launch counts, one per kernel: each wrapper adds one where it launches
# its kernel and nowhere else.
LAUNCHES = {"fused_ladder": 0, "tiled_iteration": 0, "global_update": 0,
            "coarse_disaggregate": 0}

_LOCK = threading.Lock()
_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "poseidon_tpu_torch"


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Build each source into its own shared library, one ``nvcc -shared``
    per source, all started together; returns ``{source: path}``.  Reuses
    an existing build of the same sources and flags."""
    out_dir = build_dir()
    tag = _digest()
    libs = {src: out_dir / f"{Path(src).stem}_{tag}.so" for src in _SOURCES}
    procs = {}
    for src, so in libs.items():
        if so.exists():
            continue
        out_dir.mkdir(parents=True, exist_ok=True)
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-Xptxas", "-v",
               "-o", str(so.with_suffix(".tmp")), str(_CSRC / src)]
        procs[src] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    errors = []
    for src, proc in procs.items():
        log, _ = proc.communicate()
        libs[src].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"{src}:\n{log}")
        else:
            os.replace(libs[src].with_suffix(".tmp"), libs[src])
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return libs


def ptxas_report(source: str) -> str:
    """The ``-Xptxas -v`` output (registers, spills) of the last build of
    ``source``, e.g. ``"fused_ladder.cu"``."""
    log = build()[source].with_suffix(".log")
    return log.read_text() if log.exists() else ""


def lib() -> SimpleNamespace:
    """The kernels' C entry points (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            libs = build()
            P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fns = {}

            def bind(src, name, argtypes, restype):
                fn = getattr(ctypes.CDLL(str(libs[src])), name)
                fn.argtypes, fn.restype = argtypes, restype
                fns[name] = fn

            bind("fused_ladder.cu", "pt_fused_ladder",
                 [P] * 15 + [I] * 3 + [P], I)
            bind("fused_ladder.cu", "pt_fused_ladder_smem_bytes", [I],
                 ctypes.c_size_t)
            bind("tiled_iteration.cu", "pt_tiled_iteration",
                 [P] * 27 + [I] * 7 + [P], I)
            bind("tiled_iteration.cu", "pt_tiled_iteration_ws_ints", [I, I],
                 LL)
            bind("tiled_iteration.cu", "pt_tiled_iteration_kernels", [],
                 ctypes.c_ulonglong)
            bind("global_update.cu", "pt_global_update_launch",
                 [P] * 20 + [I] * 8 + [P], I)
            bind("global_update.cu", "pt_global_update_ws_ints", [I, I, I],
                 LL)
            bind("global_update.cu", "pt_global_update_plan", [I, I, P], I)
            bind("coarse_disaggregate.cu", "pt_coarse_disaggregate",
                 [P] * 8 + [I] * 4 + [P], I)
            bind("coarse_disaggregate.cu",
                 "pt_coarse_disaggregate_smem_bytes", [I], ctypes.c_size_t)
            _LIB = SimpleNamespace(**fns)
            # The kernels' build or load is this process's compile event.
            from poseidon_tpu_torch.check.ledger import note_compile

            note_compile("cuda kernels")
        return _LIB


def check(t, name: str, shape, device) -> int:
    """Validate one kernel operand and return its data pointer: the
    kernels take contiguous int32 tensors on the launch device only."""
    import torch

    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.int32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()


def launch_check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
