"""ctypes bindings and the build of the C++ graph core.

The core is one translation unit with a plain C interface, so it builds
with ``g++ -O2 -shared -fPIC -std=c++17`` alone into a shared library
under ``build/poseidon_tpu_torch/`` at the repository root (never into
the package directory; ``POSEIDON_COMPILE_CACHE_DIR`` names another
directory), keyed by a hash of the source and flags: a fresh
checkout builds from its own source and later uses reuse the build.  The
build writes a temporary file and renames it, so processes that build at
once do not see each other's partial output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "graphcore.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_BUILD_LOCK = threading.Lock()

_lib = None
_lib_error: Optional[str] = None


def build_dir() -> Path:
    from poseidon_tpu_torch.utils.envutil import kernel_build_dir

    return kernel_build_dir()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return build_dir() / f"graphcore_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    with _BUILD_LOCK:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.CalledProcessError) as exc:
            detail = getattr(exc, "stderr", None) or ""
            _lib_error = f"{exc} {detail}".strip()
            return None
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.gc_new.restype = ctypes.c_void_p
        lib.gc_free.argtypes = [ctypes.c_void_p]
        lib.gc_machine_add.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.gc_machine_update.argtypes = lib.gc_machine_add.argtypes
        lib.gc_machine_remove.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.gc_task_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.gc_task_update.argtypes = lib.gc_task_submit.argtypes
        lib.gc_task_remove.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.gc_task_set_state.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32
        ]
        lib.gc_task_place_batch.restype = ctypes.c_int64
        lib.gc_task_place_batch.argtypes = [
            ctypes.c_void_p, u64p, u64p, ctypes.c_int64,
        ]
        lib.gc_task_place.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64
        ]
        lib.gc_view_prepare.argtypes = [
            ctypes.c_void_p, u64p, ctypes.c_int64, ctypes.c_int32
        ]
        lib.gc_view_prepare.restype = ctypes.c_int64
        lib.gc_view_num_ecs.argtypes = [ctypes.c_void_p]
        lib.gc_view_num_ecs.restype = ctypes.c_int64
        lib.gc_view_ecs.argtypes = [ctypes.c_void_p, u64p, i64p]
        lib.gc_view_members.argtypes = [ctypes.c_void_p, u64p, i32p, i32p]
        lib.gc_view_machine_aggregates.argtypes = [
            ctypes.c_void_p, i64p, i64p, i64p, i64p, i32p
        ]
        lib.gc_num_tasks.argtypes = [ctypes.c_void_p]
        lib.gc_num_tasks.restype = ctypes.c_int64
        lib.gc_num_machines.argtypes = [ctypes.c_void_p]
        lib.gc_num_machines.restype = ctypes.c_int64
        _lib = lib
    # The core's build or load is this process's compile event.
    from poseidon_tpu_torch.check.ledger import note_compile

    note_compile("native graph core")
    return _lib


def native_available() -> bool:
    return _load() is not None


def native_error() -> Optional[str]:
    """Why the core could not be built or loaded (None when it loaded)."""
    _load()
    return _lib_error


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativeGraphCore:
    """One mirrored graph-state core; thread-safety is the caller's (the
    ClusterState lock already serializes every mutation)."""

    def __init__(self) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native graphcore unavailable: {_lib_error}")
        self._lib = lib
        self._h = ctypes.c_void_p(lib.gc_new())

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.gc_free(h)
            self._h = None

    # ------------------------------------------------------------ mutators

    def machine_add(self, key, cpu, ram, net, slots) -> None:
        self._lib.gc_machine_add(self._h, key, cpu, ram, net, slots)

    def machine_update(self, key, cpu, ram, net, slots) -> None:
        self._lib.gc_machine_update(self._h, key, cpu, ram, net, slots)

    def machine_remove(self, key) -> None:
        self._lib.gc_machine_remove(self._h, key)

    def task_submit(self, uid, ec, cpu, ram, net, ttype) -> None:
        self._lib.gc_task_submit(self._h, uid, ec, cpu, ram, net, ttype)

    def task_update(self, uid, ec, cpu, ram, net, ttype) -> None:
        self._lib.gc_task_update(self._h, uid, ec, cpu, ram, net, ttype)

    def task_remove(self, uid) -> None:
        self._lib.gc_task_remove(self._h, uid)

    def task_set_state(self, uid, state) -> None:
        self._lib.gc_task_set_state(self._h, uid, int(state))

    def task_place(self, uid, machine_key) -> None:
        self._lib.gc_task_place(self._h, uid, machine_key)

    def task_place_batch(
        self, uids: np.ndarray, machine_keys: np.ndarray
    ) -> int:
        """Batched placement commit (one C call for a whole round)."""
        uids = np.ascontiguousarray(uids, dtype=np.uint64)
        keys = np.ascontiguousarray(machine_keys, dtype=np.uint64)
        if uids.shape != keys.shape:
            raise ValueError(
                f"uids/machine_keys length mismatch: {uids.shape} vs "
                f"{keys.shape}"
            )
        return int(self._lib.gc_task_place_batch(
            self._h, _ptr(uids, ctypes.c_uint64),
            _ptr(keys, ctypes.c_uint64), uids.shape[0],
        ))

    # ---------------------------------------------------------------- view

    def build_view(self, machine_keys_sorted: np.ndarray,
                   include_running: bool):
        """Aggregate + group + sort in native code.

        Returns (ec_ids[E] uint64, offsets[E+1] int64, uids[P] uint64,
        cur[P] int32, wait[P] int32, census[M,4] int64, cpu_used[M],
        ram_used[M], net_used[M] int64, slots_used[M] int32).
        """
        lib = self._lib
        keys = np.ascontiguousarray(machine_keys_sorted, dtype=np.uint64)
        M = keys.shape[0]
        P = lib.gc_view_prepare(
            self._h, _ptr(keys, ctypes.c_uint64), M,
            1 if include_running else 0,
        )
        if P < 0:
            raise RuntimeError("native view: unknown machine key")
        E = lib.gc_view_num_ecs(self._h)
        ec_ids = np.empty(E, dtype=np.uint64)
        offsets = np.empty(E + 1, dtype=np.int64)
        lib.gc_view_ecs(
            self._h, _ptr(ec_ids, ctypes.c_uint64),
            _ptr(offsets, ctypes.c_int64),
        )
        uids = np.empty(P, dtype=np.uint64)
        cur = np.empty(P, dtype=np.int32)
        wait = np.empty(P, dtype=np.int32)
        lib.gc_view_members(
            self._h, _ptr(uids, ctypes.c_uint64),
            _ptr(cur, ctypes.c_int32), _ptr(wait, ctypes.c_int32),
        )
        census = np.empty((M, 4), dtype=np.int64)
        cpu_used = np.empty(M, dtype=np.int64)
        ram_used = np.empty(M, dtype=np.int64)
        net_used = np.empty(M, dtype=np.int64)
        slots_used = np.empty(M, dtype=np.int32)
        lib.gc_view_machine_aggregates(
            self._h, _ptr(census, ctypes.c_int64),
            _ptr(cpu_used, ctypes.c_int64), _ptr(ram_used, ctypes.c_int64),
            _ptr(net_used, ctypes.c_int64), _ptr(slots_used, ctypes.c_int32),
        )
        return (ec_ids, offsets, uids, cur, wait, census, cpu_used,
                ram_used, net_used, slots_used)

    @property
    def num_tasks(self) -> int:
        return int(self._lib.gc_num_tasks(self._h))

    @property
    def num_machines(self) -> int:
        return int(self._lib.gc_num_machines(self._h))
