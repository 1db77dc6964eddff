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
class FirmamentTPUConfig:
    """Service-side configuration (the analog of Firmament's gflags flagfile,
    deploy/firmament-deployment.yaml:29)."""

    listen_address: str = "0.0.0.0:9090"
    # Prometheus exposition endpoint; the port has no exporter yet, so it
    # must stay empty.
    metrics_address: str = ""
    # Cost model selection: "cpu_mem" (the reference's active model) or
    # "trivial".
    cost_model: str = "cpu_mem"
    # Solver selection: "auction", the cost-scaling push-relabel ladder,
    # is the only solver the port has.
    flow_solver: str = "auction"
    # Build the CUDA kernels before the first Schedule() instead of in it.
    precompile: bool = False
    # Precompile ceilings of the reference's shape ladder.  Accepted as
    # hints: the port compiles nothing per shape ahead of time.
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
        for key in ("profile_dir", "metrics_address"):
            if getattr(self, key):
                raise ValueError(
                    f"{key} {getattr(self, key)!r}: the port has no "
                    f"{key.split('_')[0]} support yet; leave it empty")


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
    cls=FirmamentTPUConfig,
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
    cfg.validate()
    return cfg
