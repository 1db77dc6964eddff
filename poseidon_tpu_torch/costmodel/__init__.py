"""Cost models of the port: ``cpu_mem`` (the reference's active model),
``trivial``, the network-aware ``net`` and the interference-aware
``whare`` and ``coco``, selected by name through ``get_cost_model``."""

from poseidon_tpu_torch.costmodel.base import (  # noqa: F401
    CostMatrices,
    CostModel,
    get_cost_model,
)
from poseidon_tpu_torch.costmodel.cpu_mem import CpuMemCostModel  # noqa: F401
from poseidon_tpu_torch.costmodel.trivial import TrivialCostModel  # noqa: F401
from poseidon_tpu_torch.costmodel.interference import (  # noqa: F401
    CoCoCostModel,
    WhareMapCostModel,
)
from poseidon_tpu_torch.costmodel.net import NetAwareCostModel  # noqa: F401
