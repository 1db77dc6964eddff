"""Process-environment helpers for the card (the port of
``poseidon_tpu/utils/envutil.py``, with torch meanings).

- ``clean_cpu_env``: the environment of a child process that must not
  see the card (``CUDA_VISIBLE_DEVICES=""``).
- ``probe_device_count``: ``torch.cuda.device_count()`` in a disposable
  subprocess, so the caller never initialises CUDA itself.
- ``enable_compilation_cache``: the directory the CUDA kernels and the
  native graph core build into (``POSEIDON_COMPILE_CACHE_DIR``), so a
  restarted service reuses its builds.
- ``serialize_device_access`` / ``release_device_lock``: a host-wide
  advisory flock that admits one card-touching process at a time.
- ``install_graceful_term``: SIGTERM exits at the next bytecode
  boundary, never inside a running device call.
- ``backend_initialized``: whether this process already initialised
  CUDA.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional


def clean_cpu_env(root: str) -> dict:
    """Environment for a child process that runs on the CPU only:
    ``root`` is appended to PYTHONPATH so the child resolves the repo
    whatever its cwd, and ``CUDA_VISIBLE_DEVICES`` is emptied so torch
    in the child sees no card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
        + [root]
    )
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def probe_device_count(timeout: float = 120.0) -> int:
    """Count the CUDA devices from a disposable subprocess.

    Returns -1 when the probe dies or times out — distinct from a
    healthy host that simply has fewer devices than wanted (0 without a
    card)."""
    try:
        probe = subprocess.run(
            [sys.executable, "-c",
             "import torch; print('NDEV=%d' % torch.cuda.device_count())"],
            capture_output=True, text=True, timeout=timeout,
        )
        if probe.returncode == 0:
            for line in probe.stdout.splitlines():
                if line.startswith("NDEV="):
                    return int(line.split("=", 1)[1])
    except (subprocess.TimeoutExpired, ValueError):
        pass
    return -1


def enable_compilation_cache(path: Optional[str] = None) -> Optional[str]:
    """Name the directory the kernels build into and return it.

    ``POSEIDON_COMPILE_CACHE_DIR`` wins when the operator set it; else
    ``path``, exported as ``POSEIDON_COMPILE_CACHE_DIR`` for this process
    and its children; else nothing changes and the builds stay in the
    checkout's ``build/poseidon_tpu_torch`` (returns None).  An
    unwritable directory is left alone: the cache saves time, it is
    never a reason not to start."""
    from poseidon_tpu_torch.utils.hatches import hatch_str

    chosen = hatch_str("POSEIDON_COMPILE_CACHE_DIR") or path
    if not chosen:
        return None
    try:
        os.makedirs(chosen, exist_ok=True)
    except OSError:
        return None
    os.environ["POSEIDON_COMPILE_CACHE_DIR"] = chosen
    return chosen


def kernel_build_dir() -> Path:
    """Where the CUDA kernels (``ops/_kernels.py``) and the native graph
    core (``native/bindings.py``) build: ``POSEIDON_COMPILE_CACHE_DIR``
    when set, else ``build/poseidon_tpu_torch`` at the checkout's root."""
    from poseidon_tpu_torch.utils.hatches import hatch_str

    chosen = hatch_str("POSEIDON_COMPILE_CACHE_DIR")
    if chosen:
        return Path(chosen)
    return Path(__file__).resolve().parents[2] / "build" / "poseidon_tpu_torch"


# ---------------------------------------------------------------- device lock
#
# One advisory flock serializes every card-touching process on the host
# (the service, the chip checks, profiling tools).  The fd is held for
# the life of the process and the OS drops the lock on any exit,
# SIGKILL included, so a dead holder never leaves it stuck.

def device_lock_path() -> str:
    """Lock-file path: ``POSEIDON_DEVICE_LOCK``, read at call time so
    tests and wrappers can redirect it per acquire; by default a file
    in the process's temporary directory."""
    from poseidon_tpu_torch.utils.hatches import hatch_str

    return hatch_str("POSEIDON_DEVICE_LOCK") or os.path.join(
        tempfile.gettempdir(), "poseidon_tpu_device.lock")


_device_lock_fd: Optional[int] = None


def _may_touch_accelerator() -> bool:
    """False when this process was told to see no card
    (``CUDA_VISIBLE_DEVICES`` set and empty, as ``clean_cpu_env``
    does)."""
    return os.environ.get("CUDA_VISIBLE_DEVICES", None) != ""


# Sentinel: "use POSEIDON_DEVICE_LOCK_TIMEOUT (600 s by default)".
_ENV_TIMEOUT = object()


def serialize_device_access(timeout=_ENV_TIMEOUT) -> bool:
    """Take the host-wide card lock before CUDA's first use.

    Blocks until the lock is held, or until ``timeout`` seconds passed —
    then returns False, meaning BUSY: another process holds the card.
    ``timeout`` defaults to ``POSEIDON_DEVICE_LOCK_TIMEOUT``; None waits
    forever.  Returns True at once in a process that sees no card and
    when this process already holds the lock (reentrant; released on
    exit).  A lock file this user cannot open falls back to a per-uid
    path, and when even that fails there is nothing to serialize with.
    """
    global _device_lock_fd
    if timeout is _ENV_TIMEOUT:
        from poseidon_tpu_torch.utils.hatches import hatch_float

        timeout = hatch_float("POSEIDON_DEVICE_LOCK_TIMEOUT")
    if not _may_touch_accelerator():
        return True
    if _device_lock_fd is not None:
        return True
    try:
        import fcntl
    except ImportError:  # non-POSIX: nothing to serialize with
        return True
    lock_path = device_lock_path()
    try:
        fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o666)
    except OSError:
        try:
            fd = os.open(
                f"{lock_path}.{os.getuid()}",
                os.O_CREAT | os.O_RDWR, 0o600,
            )
        except OSError:
            return True
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            break
        except OSError:
            if deadline is not None and time.monotonic() >= deadline:
                os.close(fd)
                return False
            time.sleep(1.0)
    try:
        os.ftruncate(fd, 0)
        os.write(fd, f"pid={os.getpid()}\n".encode())
    except OSError:
        pass  # the content is diagnostic only
    _device_lock_fd = fd
    return True


def release_device_lock() -> None:
    """Drop the host-wide card lock early (a process that took it to
    probe and then settled on the CPU)."""
    global _device_lock_fd
    if _device_lock_fd is not None:
        try:
            os.close(_device_lock_fd)
        except OSError:
            pass
        _device_lock_fd = None


def install_graceful_term() -> None:
    """Make SIGTERM exit at the next Python bytecode boundary.

    A blocking device call runs inside C++, where Python signal handlers
    cannot fire, so a handler that raises SystemExit runs only after the
    call returns: a card-holding child is never killed mid-call."""
    import signal

    def _term(signum, frame):
        raise SystemExit(143)

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:
        pass  # non-main thread: the caller manages its own lifecycle


def backend_initialized() -> bool:
    """True iff this process already initialised CUDA.  Never
    initialises it itself, and reads torch only when it is loaded."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return bool(torch.cuda.is_initialized())
    except Exception:  # noqa: BLE001
        return False
