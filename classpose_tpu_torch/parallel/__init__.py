"""Several devices: the device list and per-device replicas
(``mesh``), tile-parallel inference (``inference``) and the process-group
helpers of data-parallel training (``distributed``)."""

from classpose_tpu_torch.parallel.mesh import (
    get_mesh,
    local_device_count,
    replicate,
)

__all__ = ["get_mesh", "local_device_count", "replicate"]
