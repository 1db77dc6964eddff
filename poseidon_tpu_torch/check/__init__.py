"""posecheck for the PyTorch/CUDA port: codebase-aware static analysis,
and the runtime ledgers beside it.

The port's counterpart of ``poseidon_tpu.check``.  Twelve AST rules, by
the reference's ids, each scoped to the port's subsystem whose failure
mode it guards:

- ``jit-purity``   — host reads between a kernel wrapper's launches (a
                     wrapper is a function that calls into
                     ``_kernels.lib()``; ``ops/``, ``solver/``);
- ``lock-discipline`` — unlocked writes to lock-guarded state in the
                     threaded layers (``glue/``, ``graph/pipeline.py``,
                     ``costmodel/delta.py``, ``chaos/``, ``obs/``,
                     ``service/``, ``replay/``, ``graph/residency.py``);
- ``determinism``  — wall clock / unseeded RNG (numpy's and torch's) /
                     unordered-set iteration / import-time env reads
                     (``replay/``, ``graph/``, ``ops/``, ``chaos/``,
                     ``obs/``);
- ``retrace-guard`` — solve keys and launch shapes minted per call, the
                     kernel library loaded outside ``_kernels.lib()``,
                     floats at the int32 kernel boundary (``ops/``,
                     ``graph/``);
- ``dispatch-budget`` — every kernel wrapper and solve key in ``ops/``
                     reachable from ``precompile``/``ensure_precompiled``
                     (cross-file closure; judged in ``Rule.finalize``);
- ``transfer-discipline`` — implicit device->host reads of a wrapper's
                     result or a CUDA tensor outside the declared
                     boundary (``transport._host_read``; ``ops/``,
                     ``graph/``, ``costmodel/``);
- ``shard-discipline`` — the block ladder's machine-axis reductions
                     through ``_Collectives``, pad-to-mesh-multiple, and
                     precompile reachability of the sharded solve key;
- ``hatch-registry`` — every ``POSEIDON_*`` hatch reads through the
                     port's registry (``utils/hatches.py``);
- ``lock-order``, ``blocking-under-lock``, ``unsafe-publication`` — the
                     concurrency rules over the threaded layers (a
                     device wait under a lock is a ``torch.cuda
                     .synchronize()``, a host read or a kernel launch);
- ``numerics``     — int32 overflow, inf-sentinel hygiene, and torch's
                     int64 promotion of an int32 sum without ``dtype=``.

The static suite is pure ``ast``: it imports neither torch nor the JAX
package, so ``python -m poseidon_tpu_torch.check`` (exit 1 on findings;
``--format=json`` for machines, ``--changed`` for pre-commit speed)
runs anywhere.  Suppress a finding with a trailing
``# posecheck: ignore[rule-id]`` plus a justification.

The runtime complement is ``poseidon_tpu_torch.check.ledger``: compile,
transfer and numerics budgets around warm rounds, in torch terms
(imported separately — it pulls in torch, which the static CLI does
not).
"""

from poseidon_tpu_torch.check.core import (
    Finding,
    Rule,
    all_rules,
    check_file,
    rules_by_name,
    run,
)

__all__ = [
    "Finding",
    "Rule",
    "all_rules",
    "check_file",
    "rules_by_name",
    "run",
]
