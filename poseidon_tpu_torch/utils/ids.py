"""Deterministic identifier generation.

Matches the reference's semantics (pkg/k8sclient/utils.go:36-70): job UUIDs
are derived deterministically from a seed string (there: a math/rand source
seeded with the FNV-64a hash of the seed; here: the hash bytes themselves,
shaped into an RFC-4122-style v4 UUID), and task ids are a 64-bit
hash-combine of the job UUID hash with the task index.  Determinism — the
same pod/job always maps to the same ids across restarts — is the contract
the Firmament service relies on for its ALREADY_EXISTS reply paths
(firmament_scheduler.proto:118,128); the exact bit patterns are an internal
detail.
"""

from __future__ import annotations

import struct

FNV64_OFFSET = 0xCBF29CE484222325
FNV64_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv64a(data: bytes | str) -> int:
    """FNV-1a 64-bit hash (the Go stdlib hash/fnv `New64a` used at utils.go:38)."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    h = FNV64_OFFSET
    for b in data:
        h ^= b
        h = (h * FNV64_PRIME) & _MASK64
    return h


def hash_combine(seed: int, value: int | str) -> int:
    """64-bit hash-combine, after utils.go:64-70 (boost-style mix folded to 64 bits).

    Used to derive task uids: ``task_uid = hash_combine(fnv64a(job_uuid), index)``
    (reference podwatcher.go:420-422).
    """
    if isinstance(value, str):
        value = fnv64a(value)
    seed &= _MASK64
    x = (value & _MASK64) + 0x9E3779B97F4A7C15 + ((seed << 6) & _MASK64) + (seed >> 2)
    return (seed ^ x) & _MASK64


def generate_uuid(seed: str) -> str:
    """Deterministic UUID for a seed string (utils.go:36-44 semantics).

    Two rounds of FNV-1a over the seed (second round over the first hash's
    bytes) give 128 deterministic bits, formatted as a version-4/variant-1
    UUID string.
    """
    h1 = fnv64a(seed)
    h2 = fnv64a(struct.pack("<Q", h1) + seed.encode("utf-8"))
    raw = bytearray(struct.pack("<QQ", h1, h2))
    raw[6] = (raw[6] & 0x0F) | 0x40  # version 4
    raw[8] = (raw[8] & 0x3F) | 0x80  # RFC 4122 variant
    hx = raw.hex()
    return f"{hx[0:8]}-{hx[8:12]}-{hx[12:16]}-{hx[16:20]}-{hx[20:32]}"


def task_uid(job_uuid: str, index: int) -> int:
    """Task uid = hash-combine of the job UUID hash and the task index.

    Mirrors addTaskToJob's uid derivation (podwatcher.go:412-422): the root
    task uses index 0, spawned children use their pod's index within the job.
    """
    return hash_combine(fnv64a(job_uuid), index)


def resource_uuid(seed: str) -> str:
    """Deterministic resource (node/PU) UUID, same scheme as job UUIDs."""
    return generate_uuid(seed)
