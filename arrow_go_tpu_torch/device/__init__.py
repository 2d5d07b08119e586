"""Device block format of the port (block.py), with the JAX package's
`arrow_go_tpu.device` names."""
from .block import (DeviceBatch, DeviceColumn, DeviceListColumn,  # noqa: F401
                    HostColumn, batch_from_device,
                    batch_to_device, from_device, list_from_device,
                    list_take_device, list_to_device, pad_length, row_mask,
                    to_device)
