"""Registry of the ``POSEIDON_*`` environment hatches the port reads.

The port's own closed registry (the JAX package keeps its own): every
hatch is declared once with its kind, default and effect, and the typed
accessors raise ``KeyError`` on an unregistered name, so a typo'd hatch
fails loudly instead of silently reading a default.  Accessors read the
environment at call time, never at import time.

Kinds:
  bool_on   default ON:  any value other than "0" enables
  bool_off  default OFF: only exactly "1" enables
  tristate  "1" forces on, "0" forces off, unset defers to the device
            policy (transport.accel_policy: on when the solve's device is
            CUDA)
  int/float numeric knob; unparseable values fall back to the default
  flag      set to any non-empty string (latch-style markers)
  str       string knob (paths); the default when unset or empty
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

_KINDS = ("bool_on", "bool_off", "tristate", "int", "float", "flag",
          "str")


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
    Hatch("POSEIDON_RESIDENT", "tristate", "",
          "Device-resident operand cache: upload only the changed columns "
          "of the [3, E, M] operand between solves at one padded shape "
          "(CUDA default on)"),
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
    Hatch("POSEIDON_CHAINED", "bool_off", "0",
          "Chained two-band wave device program (ops/transport_chained.py; "
          "A/B path, default OFF)"),

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
    # --------------------------------------------------------- sharded bands
    Hatch("POSEIDON_SHARDED_BANDS", "bool_off", "0",
          "Mesh-sharded band tier: split wide contended bands (where "
          "the pruned gate declines) over the visible device mesh"),
    Hatch("POSEIDON_SHARDED_MIN_COLS", "int", "8192",
          "Sharded-band gate: minimum machine columns before a band "
          "shards (quarter-octave buckets at this width keep the "
          "mesh's column padding a no-op)"),
    Hatch("POSEIDON_SHARDED_MIN_CONTENTION", "int", "50",
          "Sharded-band gate: minimum contention in percent (supply "
          "as a share of open column capacity) before a band shards"),
    Hatch("POSEIDON_SHARD_STRIDED", "bool_on", "1",
          "Strided (round-robin) column-to-shard assignment in a "
          "sharded solve; 0 gives contiguous blocks (and flows "
          "bit-identical to the one-device solve)"),

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

    Hatch("POSEIDON_STREAMING", "bool_off", "0",
          "Streaming round engine (glue/poseidon.py): overlap round N's "
          "enactment with round N+1's schedule RPC and speculate the next "
          "round's cost build across rounds; 0 runs the synchronous loop"),
    Hatch("POSEIDON_ADMISSION_STALENESS_S", "float", "0.25",
          "Streaming admission batcher: bounded-staleness deadline in "
          "seconds (the streaming loop's round cadence)"),
    Hatch("POSEIDON_INGEST_STALL_S", "float", "60",
          "Seconds without a watcher event before /healthz reports a "
          "wedged ingest path (503) under streaming; 0 disables"),

    Hatch("POSEIDON_TRACE", "bool_off", "0",
          "Record hierarchical spans (Perfetto-exportable; obs/trace.py)"),
    Hatch("POSEIDON_STAGE_TIMERS", "bool_off", "0",
          "Aggregate per-span wall timings without recording spans"),
    Hatch("POSEIDON_JAX_PROFILE", "str", "",
          "Directory for torch.profiler captures around each round's "
          "solve window (obs/profile.py; empty = off; the reference's "
          "name)"),
    Hatch("POSEIDON_ROUND_HISTORY", "int", "128",
          "Round-history ring capacity behind /debug/rounds "
          "(obs/history.py); 0 disables recording"),
    Hatch("POSEIDON_LOCK_LEDGER", "bool_on", "1",
          "TrackedLock order/contention/hold accounting (utils/locks.py); "
          "0 degrades every tracked lock to a bare delegate"),
    Hatch("POSEIDON_RACE_SEED", "int", "0",
          "Base seed for the preemption-point race harness "
          "(chaos/preempt.py; suite seed k runs at base + k)"),
    Hatch("POSEIDON_RACE_SWEEP", "int", "3",
          "Seeded interleavings each race-harness suite drives"),
    Hatch("POSEIDON_NUMERICS_LEDGER", "bool_off", "0",
          "Validate every _host_read result against the numerics "
          "contract (finite floats, int32 values clear of the rails); "
          "anomalies feed RoundMetrics.numeric_anomalies and any open "
          "check.ledger.NumericsLedger window"),
    Hatch("POSEIDON_NUMERICS_SCOPES", "str", "",
          "Comma-separated path fragments overriding the posecheck "
          "`numerics` rule's default scope (poseidon_tpu_torch/ops/, "
          "poseidon_tpu_torch/costmodel/, poseidon_tpu_torch/graph/)"),

    Hatch("POSEIDON_COMPILE_CACHE_DIR", "str", "",
          "Build directory of the CUDA kernels and the native graph core "
          "(ops/_kernels.build_dir; empty = build/poseidon_tpu_torch "
          "under the checkout)"),
    Hatch("POSEIDON_DEVICE_LOCK", "str", "",
          "Path of the host-wide exclusive accelerator flock (empty = "
          "poseidon_tpu_device.lock in the process's temporary "
          "directory)"),
    Hatch("POSEIDON_DEVICE_LOCK_TIMEOUT", "float", "600",
          "Seconds to wait for the accelerator lock before declaring "
          "BUSY"),

    Hatch("POSEIDON_REPLAY_PROGRESS", "flag", "",
          "Per-round progress breadcrumbs on stderr during replay"),
    Hatch("POSEIDON_SCENARIO_OUT", "str", "out/scenario",
          "Flight-trace output directory for scenario drives "
          "(scenario/drive.py; replay/flight.py re-drives traces from "
          "here)"),
    Hatch("POSEIDON_SCENARIO_AMPLITUDE", "float", "0.15",
          "Cost-perturbation amplitude for robustness scoring, as a "
          "fraction of NORMALIZED_COST added to every admissible cost "
          "cell (scenario/score.PerturbedCostModel)"),
    Hatch("POSEIDON_SCENARIO_SEEDS", "int", "3",
          "How many chaos-seeded cost-perturbation drives a scenario "
          "robustness score aggregates (scenario/score.score_scenario)"),
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


def hatch_set(name: str) -> bool:
    """True iff the hatch is present in the environment at all (the
    tracer's fully-disabled fast path needs exactly this)."""
    hatch(name)
    return name in os.environ


def hatch_bool(name: str) -> bool:
    """``bool_on`` hatches disable only on exactly "0"; ``bool_off``
    hatches enable only on exactly "1"."""
    h = hatch(name)
    raw = os.environ.get(name, h.default)
    if h.kind == "bool_on":
        return raw != "0"
    if h.kind == "bool_off":
        return raw == "1"
    raise TypeError(f"hatch {name} is {h.kind}, not a bool gate")


def hatch_flag(name: str) -> bool:
    """True iff set to any non-empty string (latch-style markers)."""
    h = hatch(name)
    if h.kind != "flag":
        raise TypeError(f"hatch {name} is {h.kind}, not a flag")
    return bool(os.environ.get(name))


def hatch_str(name: str) -> str:
    """String knob (paths); the declared default when unset or empty."""
    h = hatch(name)
    if h.kind != "str":
        raise TypeError(f"hatch {name} is {h.kind}, not a string knob")
    return os.environ.get(name) or h.default


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
    return _numeric_fallback(h, default, int)


def hatch_float(name: str, default: Optional[float] = None) -> float:
    h = hatch(name)
    if h.kind != "float":
        raise TypeError(f"hatch {name} is {h.kind}, not a float knob")
    raw = os.environ.get(name)
    if raw is not None:
        try:
            return float(raw)
        except ValueError:
            pass
    return _numeric_fallback(h, default, float)


def _numeric_fallback(h: Hatch, default, conv):
    if default is not None:
        return default
    if h.default == "":
        raise TypeError(f"hatch {h.name} declares no default; pass default=")
    return conv(h.default)


_KIND_LABEL = {
    "bool_on": "bool (default on; `0` disables)",
    "bool_off": "bool (default off; `1` enables)",
    "flag": "flag (any non-empty value)",
    "tristate": "tristate (`1` on / `0` off / unset = device policy)",
    "int": "int",
    "float": "float",
    "str": "string",
}


def markdown_table() -> str:
    """The port's hatch table as markdown (``python -m
    poseidon_tpu_torch.utils.hatches``)."""
    lines = [
        "# POSEIDON_* escape hatches (torch port)",
        "",
        "GENERATED by `python -m poseidon_tpu_torch.utils.hatches` from the",
        "registry in `poseidon_tpu_torch/utils/hatches.py`.",
        "",
        "| hatch | kind | default | effect |",
        "| --- | --- | --- | --- |",
    ]
    for h in HATCHES:
        default = h.default if h.default != "" else "(unset)"
        lines.append(
            f"| `{h.name}` | {_KIND_LABEL[h.kind]} | `{default}` | "
            f"{h.doc} |"
        )
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    print(markdown_table(), end="")
