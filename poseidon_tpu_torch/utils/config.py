"""Configuration system: CLI flags + optional YAML/JSON config file.

Re-creates the reference's pflag+viper semantics (pkg/config/config.go:31-133):
a fixed set of options with defaults, overridable by a config file
(``--config-file``), with explicit CLI flags taking precedence over the file.
Unknown flags and malformed values are errors, as with pflag.  Defaults match
config.go:113-128 / the deploy manifests.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass, fields
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import yaml


@dataclass
class PoseidonConfig:
    """Client-side (glue) configuration — config.go:31-40."""

    scheduler_name: str = "poseidon"
    firmament_address: str = "firmament-service.kube-system:9090"
    kube_config: str = ""
    kube_version: str = "1.6"
    stats_server_address: str = "0.0.0.0:9091"
    # Prometheus exposition endpoint (obs/metrics.MetricsServer).  Empty
    # disables the exporter (the test-harness default).
    metrics_address: str = ""
    scheduling_interval: float = 10.0  # seconds; config.go:120
    # RPC hardening (the reference has none of these: its client blocks
    # forever on a wedged Firmament): per-RPC deadline, bounded retry
    # with exponential backoff + jitter (service/client.py).
    rpc_timeout_s: float = 30.0
    rpc_retries: int = 3
    rpc_backoff_s: float = 0.05
    # Crash-loop budget for the schedule loop (glue/poseidon.py): after
    # this many CONSECUTIVE failed rounds the loop stops fatally instead
    # of log-and-spin; failed rounds back off exponentially from
    # crash_backoff_s up to crash_backoff_max_s between retries.
    crash_loop_budget: int = 8
    crash_backoff_s: float = 0.5
    crash_backoff_max_s: float = 30.0
    config_file: str = ""

    def kube_version_tuple(self) -> tuple:
        """(major, minor) — the reference fatals on malformed versions
        (GetKubeVersion, config.go:61-72); here that is a ValueError."""
        parts = self.kube_version.split(".")
        try:
            return int(parts[0]), int(parts[1])
        except (IndexError, ValueError):
            raise ValueError(
                f"incorrect content in --kube-version {self.kube_version!r}"
            ) from None


@dataclass
class FirmamentTPUConfig:
    """Service-side configuration (the analog of Firmament's gflags flagfile,
    deploy/firmament-deployment.yaml:29)."""

    listen_address: str = "0.0.0.0:9090"
    # Prometheus exposition endpoint (obs/metrics.MetricsServer) for the
    # service process, where the rounds run.  Empty disables it.
    metrics_address: str = ""
    # Cost model selection: "cpu_mem" (the reference's active model) or
    # "trivial".
    cost_model: str = "cpu_mem"
    # Solver selection: "auction", the cost-scaling push-relabel ladder,
    # is the only solver the port has.
    flow_solver: str = "auction"
    # Precompile ceilings: with precompile=True the first Schedule()
    # runs the planner's precompile — the kernels' load and one probe
    # solve per (E_bucket, M_bucket) solve key up to these bounds — so
    # churn rounds never pay a first launch or a key's first sight.
    precompile: bool = False
    max_machines: int = 1024
    max_ecs: int = 256
    # Default per-machine task slots when the node topology carries no
    # task_capacity (the Firmament --max_tasks_per_pu analog).
    max_tasks_per_pu: int = 100
    # Feature gates: tasks opt in via labels; these disable the machinery
    # wholesale (gang repair re-solves / affinity cost terms).
    gang_scheduling: bool = True
    pod_affinity: bool = True
    # Devices the solve's machine axis is split over; the port solves on
    # one.
    solver_devices: int = 1
    # Per-round profiler captures; the port has no profiler hook yet, so
    # it must stay empty.
    profile_dir: str = ""
    # Checkpoint/restore: when set, the service restores state + solver
    # warm frames from this path at startup and saves on shutdown;
    # checkpoint_every_rounds > 0 also saves after every Nth round.
    checkpoint_path: str = ""
    checkpoint_every_rounds: int = 0
    # The solve's device: "cuda" (default) or "cpu".
    device: str = "cuda"
    config_file: str = ""

    def validate(self) -> None:
        """Raise ``ValueError`` on a value the port cannot honour yet,
        rather than run something other than what was asked for."""
        if self.flow_solver != "auction":
            raise ValueError(
                f"flow_solver {self.flow_solver!r}: the port has only the "
                "'auction' solver")
        if self.solver_devices != 1:
            raise ValueError(
                f"solver_devices {self.solver_devices}: the port solves on "
                "one device")
        if self.profile_dir:
            raise ValueError(
                f"profile_dir {self.profile_dir!r}: the port has no "
                "profile support yet; leave it empty")


def _str2bool(s: str) -> bool:
    low = s.lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"invalid boolean value: {s!r}")


def _apply_file(cfg: Any, path: str) -> None:
    text = Path(path).read_text()
    data = (
        json.loads(text) if path.endswith(".json") else yaml.safe_load(text)
    ) or {}
    valid = {f.name for f in fields(cfg)}
    for key, value in data.items():
        norm = key.replace("-", "_")
        # Accept the reference's camelCase file keys (deploy/configs/*.yaml).
        snake = "".join("_" + c.lower() if c.isupper() else c for c in norm)
        if snake in valid:
            setattr(cfg, snake, value)
        elif norm in valid:
            setattr(cfg, norm, value)


def load_config(
    cls=PoseidonConfig,
    argv: Optional[Sequence[str]] = None,
    overrides: Optional[Dict[str, Any]] = None,
) -> Any:
    """Build a config: defaults < config file < CLI flags < overrides.

    ``argv`` defaults to the real process arguments (``sys.argv[1:]``).  The
    file-then-flags precedence mirrors ReadFromConfigFile /
    ReadFromCommandLineFlags (config.go:96-133).
    """
    if argv is None:
        argv = sys.argv[1:]
    cfg = cls()
    parser = argparse.ArgumentParser(prog="poseidon_tpu_torch", allow_abbrev=False)
    for f in fields(cls):
        flag = "--" + f.name.replace("_", "-")
        default = getattr(cfg, f.name)
        if isinstance(default, bool):
            # pflag-style: bare `--flag` means true, `--flag=false` works too.
            parser.add_argument(
                flag, dest=f.name, default=None, type=_str2bool,
                nargs="?", const=True,
            )
        else:
            parser.add_argument(flag, dest=f.name, default=None, type=type(default))
    ns = parser.parse_args(argv)

    if getattr(ns, "config_file", None):
        _apply_file(cfg, ns.config_file)
    for f in fields(cls):
        val = getattr(ns, f.name, None)
        if val is not None:
            setattr(cfg, f.name, val)
    for key, value in (overrides or {}).items():
        setattr(cfg, key, value)
    if hasattr(cfg, "validate"):
        cfg.validate()
    return cfg
