"""Registry of the ``POSEIDON_*`` environment hatches the port reads.

The port's own closed registry (the JAX package keeps its own): every
hatch is declared once with its kind, default and effect, and the typed
accessors raise ``KeyError`` on an unregistered name, so a typo'd hatch
fails loudly instead of silently reading a default.  Accessors read the
environment at call time, never at import time.

Kinds:
  bool_on   default ON:  any value other than "0" enables
  tristate  "1" forces on, "0" forces off, unset defers to the device
            policy (transport.accel_policy: on when the solve's device is
            CUDA)
  int       numeric knob; unparseable values fall back to the default
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

_KINDS = ("bool_on", "tristate", "int")


@dataclass(frozen=True)
class Hatch:
    name: str
    kind: str
    default: str  # string form; "" means device-dependent
    doc: str

    def __post_init__(self) -> None:
        if not self.name.startswith("POSEIDON_"):
            raise ValueError(f"hatch {self.name!r} must be POSEIDON_*")
        if self.kind not in _KINDS:
            raise ValueError(f"hatch {self.name}: unknown kind {self.kind!r}")


HATCHES: Tuple[Hatch, ...] = (
    Hatch("POSEIDON_ITER_UNROLL", "int", "",
          "Push/relabel iterations per host read of the phase status "
          "(default 4 on CUDA, 1 on CPU)"),
    Hatch("POSEIDON_HOST_CERT", "bool_on", "1",
          "Pre-dispatch host certificate: return a start that certifies "
          "exactly without launching the device solve"),
    Hatch("POSEIDON_ADAPTIVE_LADDER", "bool_on", "1",
          "Adaptive epsilon-ladder entry at a rejected host-cert "
          "candidate's certified eps, plus the pruned path's escalation "
          "warm carry"),

    Hatch("POSEIDON_ADAPTIVE_BF", "tristate", "",
          "Excess-decay-adaptive global-update cadence (CUDA default on)"),
    Hatch("POSEIDON_FUSED", "tristate", "",
          "Fused ladder kernel for shapes inside the fused gate (CUDA "
          "default on; 0 runs the plain torch ladder)"),
    Hatch("POSEIDON_TILED", "tristate", "",
          "Per-iteration kernel for shapes past the fused gate (CUDA "
          "default on; 0 runs the plain torch iteration)"),

    Hatch("POSEIDON_COARSE", "bool_on", "1",
          "Fresh-wave coarse warm start: solve the machine-aggregated "
          "instance and lift its duals"),
    Hatch("POSEIDON_COARSE_FUSED", "tristate", "",
          "Fresh-wave coarse start as one device program (coarse ladder, "
          "lift, disaggregation, certificate, full ladder; CUDA default "
          "on; 0 runs the host two-dispatch coarse start)"),
    Hatch("POSEIDON_COARSE_PINNED", "bool_on", "1",
          "Run the one-program coarse start on pinned-scale (pruned) "
          "planes too; 0 keeps those planes on the host coarse start"),
    Hatch("POSEIDON_SOLVE_TELEMETRY", "bool_on", "1",
          "Convergence-telemetry ring: one int32 sample per active "
          "push/relabel iteration, written on the device and read with "
          "the solve's one small result read; 0 threads no ring"),
    Hatch("POSEIDON_SOLVE_TELEMETRY_CAP", "int", "512",
          "Convergence-telemetry ring capacity in samples (rounded up "
          "to a multiple of 128; 0 threads no ring)"),

    Hatch("POSEIDON_MERGE_BANDS", "tristate", "",
          "Merge compatible size bands into one solve (CUDA default on)"),

    Hatch("POSEIDON_PRUNED", "bool_on", "1",
          "Pruned-plane solve path: per-row shortlists + price-out "
          "loop + full-plane certificate"),
    Hatch("POSEIDON_PRUNE_MIN_ROWS", "int", "192",
          "Classic row gate: minimum EC rows before a plane prunes"),
    Hatch("POSEIDON_PRUNE_MIN_COLS", "int", "4096",
          "Minimum machine columns before a plane prunes"),
    Hatch("POSEIDON_PRUNE_WAVE", "bool_on", "1",
          "Wave-shaped secondary prune gate (few rows x very wide); 0 "
          "restores the classic row gate exactly"),
    Hatch("POSEIDON_PRUNE_WAVE_MIN_ROWS", "int", "16",
          "Wave gate: minimum EC rows"),
    Hatch("POSEIDON_PRUNE_WAVE_MIN_COLS", "int", "8192",
          "Wave gate: minimum machine columns"),
    Hatch("POSEIDON_CERT_CACHE", "bool_on", "1",
          "Reduced-plane excluded-column certificate cache fed from "
          "the delta-plane ledger"),

    Hatch("POSEIDON_COST_DELTA", "bool_on", "1",
          "Delta-maintained cost planes (costmodel/delta.py); 0 forces "
          "full rebuilds"),
    Hatch("POSEIDON_COST_DELTA_MIN_CELLS", "int", "2048",
          "Minimum E*M cells before delta maintenance pays"),
    Hatch("POSEIDON_COST_DELTA_MIN_ROWS", "int", "8",
          "Minimum EC rows before delta maintenance pays"),
    Hatch("POSEIDON_PIPELINE_BANDS", "bool_on", "1",
          "Cross-band cost-build pipelining on a worker thread (host "
          "numpy only)"),
    Hatch("POSEIDON_OVERLAP_ASSIGN", "bool_on", "1",
          "Overlap finished bands' EC->task assignment with the next "
          "band's solve (host numpy on a worker thread)"),
)

_BY_NAME = {h.name: h for h in HATCHES}


def hatch(name: str) -> Hatch:
    """The declaration for ``name``; KeyError on unregistered names."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"unregistered hatch {name!r}: declare it in "
            "poseidon_tpu_torch/utils/hatches.py"
        ) from None


def hatch_raw(name: str) -> Optional[str]:
    """The raw environment value (None when unset), read at call time."""
    hatch(name)
    return os.environ.get(name)


def hatch_bool(name: str) -> bool:
    h = hatch(name)
    if h.kind != "bool_on":
        raise TypeError(f"hatch {name} is {h.kind}, not a bool gate")
    return os.environ.get(name, h.default) != "0"


def hatch_int(name: str, default: Optional[int] = None) -> int:
    h = hatch(name)
    if h.kind != "int":
        raise TypeError(f"hatch {name} is {h.kind}, not an int knob")
    raw = os.environ.get(name)
    if raw is not None:
        try:
            return int(raw)
        except ValueError:
            pass
    if default is not None:
        return default
    if h.default == "":
        raise TypeError(f"hatch {name} declares no default; pass default=")
    return int(h.default)
