"""Helpers the metric readers (``metrics/<name>.py``) share.  A reader
takes the run's record and returns a number, or None when the record
holds nothing for it to read."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from portbench import tracing

# HBM bandwidth of one H100 SXM (NVIDIA's data sheet, at the 700 W
# power limit), the bound of a kernel that streams its planes.
HBM_BYTES_PER_S = 3.35e12


def rounds(rec: dict, kind: str, with_view: bool = False) -> List[dict]:
    """The record's rounds of ``kind`` (``burst``; ``stream``, an open
    loop's rounds in the window) that the server saw, and with
    ``with_view`` only those that took a snapshot of the cluster."""
    return [r for r in rec["rounds"] if r["kind"] == kind and "server" in r
            and (not with_view or r["server"]["view"] is not None)]


def mean(values) -> Optional[float]:
    values = list(values)
    return float(np.mean(values)) if values else None


def stage_mean(rec: dict, kind: str, stage: str,
               with_view: bool = False) -> Optional[float]:
    """A program stage's seconds per round of ``kind`` (traced runs);
    None where no round ran the stage."""
    rs = [r for r in rounds(rec, kind, with_view) if "stages" in r["server"]]
    if not rs or not any(stage in r["server"]["stages"] for r in rs):
        return None
    return mean(r["server"]["stages"].get(stage, 0.0) for r in rs)


def client_spans(rec: dict, kind: str) -> list:
    return [tuple(r["client"]) for r in rounds(rec, kind)]


def idle_pct(rec: dict, spans) -> Optional[float]:
    """100 minus the share of ``spans`` in which a device operation ran."""
    if not rec.get("trace") or not spans:
        return None
    covered, total = tracing.busy(rec["ops"], spans)
    return 100.0 * (1.0 - covered / total) if total > 0 else None
