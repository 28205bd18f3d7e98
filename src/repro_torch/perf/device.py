"""DeviceSpec — the one place the planning stack's hardware peaks live.

Every number the planning stack knows about a *device* (as opposed to a
*link*: those are :class:`repro_torch.plan.cost.LinkSpec`) is a field
here: peak matmul FLOP/s, HBM bandwidth, per-kernel launch overhead, HBM
capacity, the per-chip interconnect bandwidth, and whether the device
runs the port's CUDA kernels.  ``plan.cost.ClusterSpec`` embeds one, so
the compute stream of the pipelined pricing and the tuner read one
source.

Two ways to get a spec:

  * ``get_device(name)`` — a preset: ``"h100-sxm"`` (NVIDIA's H100 SXM
    data sheet) or ``"cpu-host"`` (a host CPU, for tests);
  * ``DeviceSpec.from_measured(path)`` — calibrated from a
    ``repro_torch.benchmarks.kernel_sweep`` JSON: HBM bandwidth, kernel
    launch overhead and peak FLOP/s least-squares-fitted from kernels
    timed on the card the process runs on.

``as_device`` takes either, or ``"measured:<path>"``.

The roofline time of a kernel sequence on a device is

    t = max(flops / peak_flops, hbm_bytes / hbm_bw) + kernels * kernel_overhead

— compute- or memory-bound, whichever ceiling binds, plus one launch
overhead per kernel dispatched (what makes an unfused multi-pass chain
lose to a fused single-pass kernel at equal byte counts).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

BACKENDS = ("cuda", "cpu")


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One accelerator's peaks (per chip)."""

    name: str
    peak_flops: float        # bf16 matmul FLOP/s
    hbm_bw: float            # HBM bytes/s
    kernel_overhead: float   # seconds per kernel launch (dispatch)
    hbm_bytes: int = 80 * 10 ** 9    # HBM capacity
    ici_bw: float = 450e9    # per-chip interconnect bytes/s, one direction
    # "cuda": a CUDA tensor on this device takes the port's kernels, so
    # the fused compress and Adam paths are what runs (and is priced);
    # "cpu": the plain versions run
    backend: str = "cuda"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{self.backend!r}")

    @property
    def runs_kernels(self) -> bool:
        """True when the port's fused kernels run on this device."""
        return self.backend == "cuda"

    def roofline_time(self, flops: float, hbm_bytes: float,
                      kernels: int = 0) -> float:
        """Seconds for a kernel sequence: the binding roofline ceiling
        plus one launch overhead per kernel."""
        return (max(flops / self.peak_flops, hbm_bytes / self.hbm_bw)
                + kernels * self.kernel_overhead)

    @property
    def hbm_capacity(self) -> Optional[int]:
        """Per-rank memory capacity in bytes.  ``cpu-host``: the
        machine's installed RAM (None without ``psutil``: no capacity
        constraint rather than a wrong one).  A CUDA spec: the current
        card's memory when a card is present, else ``hbm_bytes``."""
        if self.name == "cpu-host":
            return host_memory_bytes()
        if self.runs_kernels:
            import torch
            if torch.cuda.is_available():
                return int(torch.cuda.get_device_properties(
                    torch.cuda.current_device()).total_memory)
        return self.hbm_bytes

    @classmethod
    def from_measured(cls, path: str, name: Optional[str] = None,
                      base: str = "h100-sxm") -> "DeviceSpec":
        """Build a spec from a ``repro_torch.benchmarks.kernel_sweep``
        JSON: HBM bandwidth, launch overhead and (when the sweep timed a
        matmul) peak FLOP/s, calibrated from timed kernels.

        Fields the sweep did not observe fall back to the ``base``
        preset.  A sweep whose fit clamped a coefficient (a non-empty
        ``clamped`` list) is a failed calibration and is refused."""
        with open(path) as f:
            data = json.load(f)
        if data.get("clamped"):
            raise ValueError(
                f"{path}: calibration clamped {data['clamped']}: the "
                "timings did not resolve these terms (noise or too narrow "
                "a sweep); run repro_torch.benchmarks.kernel_sweep again "
                "on the card instead of loading this fit")
        fallback = get_device(base)
        return cls(
            name=str(data.get("name", "measured")) if name is None else name,
            peak_flops=float(data.get("peak_flops")
                             or fallback.peak_flops),
            hbm_bw=float(data["hbm_bw"]),
            kernel_overhead=float(data["kernel_overhead"]),
            hbm_bytes=int(data.get("hbm_bytes", fallback.hbm_bytes)),
            ici_bw=float(data.get("ici_bw", fallback.ici_bw)),
            backend=str(data.get("backend", fallback.backend)))


# --------------------------------------------------------------------------
# presets
# --------------------------------------------------------------------------

DEVICES: Dict[str, DeviceSpec] = {
    # NVIDIA H100 SXM data sheet (dense, 700 W): bf16 989 TFLOP/s, HBM3
    # 3.35 TB/s, 80 GB; NVLink 900 GB/s both directions together (450 each
    # way).  The launch overhead is a guess that
    # repro_torch.benchmarks.kernel_sweep replaces with the card's own.
    "h100-sxm": DeviceSpec("h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                           kernel_overhead=5e-6, hbm_bytes=80 * 10 ** 9,
                           ici_bw=450e9, backend="cuda"),
    # a host CPU running the plain versions: tiny peaks, a fat launch
    # overhead (the reference's numbers, for tests)
    "cpu-host": DeviceSpec("cpu-host", peak_flops=2e11, hbm_bw=2e10,
                           kernel_overhead=5e-5, hbm_bytes=64 * 1024 ** 3,
                           ici_bw=1e10, backend="cpu"),
}

# the same data sheet's dense peak for each operand type, for one kernel's
# roofline bound (``kernel_bound``): f32 on the FMA pipe, f32 operands on
# the tensor cores at the TF32 rate, and the 16-bit types
H100_OPS_PER_S = {"f32": 67e12, "tf32": 495e12,
                  "bf16": DEVICES["h100-sxm"].peak_flops,
                  "fp16": DEVICES["h100-sxm"].peak_flops}


def kernel_bound(n_bytes: float, n_ops: float, ops: str = "f32"):
    """(ms, "bytes" or "operations"): the least time an H100 SXM takes to
    move ``n_bytes`` through HBM and do ``n_ops`` operations of type
    ``ops`` (a key of ``H100_OPS_PER_S``), whichever is longer."""
    t_bytes = n_bytes / DEVICES["h100-sxm"].hbm_bw * 1e3
    t_ops = n_ops / H100_OPS_PER_S[ops] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


MEASURED_PREFIX = "measured:"


def host_memory_bytes() -> Optional[int]:
    """Total installed host RAM in bytes (``psutil``), or None."""
    try:
        import psutil
    except ImportError:
        return None
    return int(psutil.virtual_memory().total)


def get_device(name: str) -> DeviceSpec:
    if name not in DEVICES:
        raise KeyError(f"unknown device preset {name!r}; "
                       f"registered: {sorted(DEVICES)}")
    return DEVICES[name]


def list_devices():
    return sorted(DEVICES)


def as_device(obj) -> DeviceSpec:
    """Accept a DeviceSpec, a preset name, or ``measured:<path>`` (a
    ``kernel_sweep`` JSON, loaded over the ``h100-sxm`` preset)."""
    if isinstance(obj, DeviceSpec):
        return obj
    if isinstance(obj, str):
        if obj.startswith(MEASURED_PREFIX):
            return DeviceSpec.from_measured(obj[len(MEASURED_PREFIX):])
        return get_device(obj)
    raise TypeError(f"not a device spec: {obj!r}")
