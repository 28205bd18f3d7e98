"""repro_torch.perf — compute as a priced stream.

  * :mod:`repro_torch.perf.device`      — DeviceSpec: the one place
                                          hardware peaks live (presets and
                                          ``DeviceSpec.from_measured``)
  * :mod:`repro_torch.perf.kernel_cost` — ComputeSpec: declared FLOPs /
                                          HBM bytes / launches of the
                                          compress, EF and Adam hot path

``repro_torch.plan.cost`` prices these against the cluster's DeviceSpec
as a third ("compute") stream beside the intra and cross link streams.
``repro_torch.benchmarks.kernel_sweep`` calibrates HBM bandwidth, launch
overhead and peak FLOP/s from timed kernels, as ``comm_sweep`` does for
links.
"""
from repro_torch.perf.device import (DEVICES, DeviceSpec, as_device,
                                     get_device, host_memory_bytes,
                                     list_devices)
from repro_torch.perf.kernel_cost import (ComputeSpec, ZERO_COMPUTE,
                                          adam_update_cost, combine_cost,
                                          ef_combine_cost, elementwise_pass)

__all__ = [
    "DEVICES", "DeviceSpec", "ComputeSpec", "ZERO_COMPUTE",
    "adam_update_cost", "as_device", "combine_cost", "ef_combine_cost",
    "elementwise_pass", "get_device", "host_memory_bytes", "list_devices",
]
