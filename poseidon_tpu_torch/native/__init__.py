"""Native (C++) runtime components of the port.

``graphcore.cpp`` is the incremental graph-state core under
``ClusterState`` (the reference's own source, kept verbatim): built at
first use with g++ into ``build/poseidon_tpu_torch/`` and bound through
ctypes.  ``ClusterState`` keeps its pure-Python round-view builder when
the core cannot be built, and logs a warning.
"""

from poseidon_tpu_torch.native.bindings import (
    NativeGraphCore,
    native_available,
    native_error,
)

__all__ = ["NativeGraphCore", "native_available", "native_error"]
