"""Wire-contract protos: verbatim copies of the JAX package's generated
modules (byte-identical serialized descriptors, so both packages can
register them in one process without a clash)."""

from poseidon_tpu_torch.protos import firmament_pb2  # noqa: F401
from poseidon_tpu_torch.protos import poseidonstats_pb2 as stats_pb2  # noqa: F401

__all__ = ["firmament_pb2", "stats_pb2"]
