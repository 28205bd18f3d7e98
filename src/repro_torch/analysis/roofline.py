"""Roofline analysis of one traced step: the port of
``repro/analysis/roofline.py``.

The reference parses the compiled HLO of a step (``analyze_compiled``);
the port has no compiled artifact, so it counts a step while it runs, on
any device and on the meta device too, where nothing is computed (the dry
run, ``launch.dryrun``).  :func:`analyze_traced` is ``analyze_compiled``'s
counterpart; it runs ``fn`` once under :class:`StepCounter`, which counts

  * dot FLOPs: every matmul and convolution, forward and backward
    (``torch.utils.flop_counter.FlopCounterMode``);
  * dot / convolution operand + result bytes, the HBM traffic estimate (a
    ``TorchDispatchMode`` over the same ops);
  * collective bytes by kind, at the ``torch.distributed`` call boundary
    (:class:`ByteCounter`), in the reference's convention: an all-reduce
    twice its buffer, an all-gather its gathered output, a reduce-scatter
    and an all-to-all their input;
  * the hand-written kernels: each launch a meta tensor stands in for
    (``kernels.build.meta_launch``), priced by its
    ``perf.kernel_cost`` FLOPs and bytes and added to the totals.

All quantities are per rank: the step is this rank's program.  The three
roofline terms (seconds) are priced against a
:class:`repro_torch.perf.device.DeviceSpec`, ``h100-sxm`` by default:

  compute    = dot_flops / device.peak_flops
  memory     = hbm_bytes / device.hbm_bw
  collective = coll_bytes / device.ici_bw
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import build
from repro_torch.obs.trace import COLLECTIVE_KINDS
from repro_torch.perf.device import DEVICES, DeviceSpec, as_device

H100 = DEVICES["h100-sxm"]

_aten = torch.ops.aten
# the ops whose operands and result count as HBM traffic (the reference's
# dot and convolution instructions); under ``torch.inference_mode`` the
# composite ops reach a dispatch mode whole, not as their mm / bmm
_DOT_OPS = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm,
            _aten.convolution, _aten._convolution,
            _aten.convolution_backward, _aten.matmul, _aten.einsum,
            _aten.linear, _aten.conv2d}


def _nbytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(o) for o in obj)
    return 0


class _DotBytes(TorchDispatchMode):
    """Operand + result bytes of every dot / convolution dispatched."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _DOT_OPS:
            self.bytes += _nbytes(args) + _nbytes(out)
        return out


class ByteCounter(contextlib.AbstractContextManager):
    """Counts the collective bytes this rank hands ``torch.distributed``
    while installed, by the reference's convention (see module doc).
    ``calls`` records each call as (function name, bytes), in order;
    ``by_kind`` sums them by the reference's HLO op names."""

    KINDS = COLLECTIVE_KINDS

    def __init__(self):
        self.bytes = 0
        self.calls = []
        self.by_kind: Dict[str, float] = defaultdict(float)
        self._saved = {}

    def _wrap(self, name: str, nbytes):
        orig = getattr(dist, name)

        def counted(*args, **kwargs):
            n = nbytes(*args)
            self.bytes += n
            self.calls.append((name, n))
            self.by_kind[self.KINDS[name]] += n
            return orig(*args, **kwargs)
        self._saved[name] = orig
        setattr(dist, name, counted)

    def __enter__(self):
        self._wrap("all_to_all_single", lambda out, inp, *a: _nbytes(inp))
        self._wrap("all_reduce", lambda t, *a: 2 * _nbytes(t))
        self._wrap("reduce_scatter_tensor", lambda out, inp, *a: _nbytes(inp))
        for name in ("all_gather_into_tensor", "all_gather_single"):
            if hasattr(dist, name):
                self._wrap(name, lambda out, inp, *a: _nbytes(out))
        return self

    def __exit__(self, *exc):
        for name, orig in self._saved.items():
            setattr(dist, name, orig)
        self._saved = {}
        return False


@dataclasses.dataclass
class RooflineReport:
    # per-rank quantities
    dot_flops: float
    hbm_bytes: float                 # dot operand/result traffic (estimate)
    coll_bytes: float                # collective bytes (wire convention)
    coll_by_kind: Dict[str, float]
    # the reference's XLA cross-check numbers (no compiler here: None)
    xla_flops: Optional[float] = None
    xla_bytes: Optional[float] = None
    # memory per rank: the live bytes before the step and its peak above
    arg_bytes: Optional[int] = None
    out_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    # the card the terms are rooflined against (perf.device)
    device: DeviceSpec = H100
    # the hand-written kernels in the totals: name -> {"launches",
    # "flops", "bytes"}
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    @property
    def peak_flops(self) -> float:
        return self.device.peak_flops

    @property
    def hbm_bw(self) -> float:
        return self.device.hbm_bw

    @property
    def ici_bw(self) -> float:
        return self.device.ici_bw

    @property
    def t_compute(self) -> float:
        return self.dot_flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        """No-overlap-free lower bound = max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def summary(self) -> Dict[str, object]:
        return {
            "dot_flops_per_dev": self.dot_flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "coll_by_kind": dict(self.coll_by_kind),
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "arg_bytes": self.arg_bytes,
            "temp_bytes": self.temp_bytes,
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
        }


class StepCounter(contextlib.ExitStack):
    """Counts the FLOPs, dot bytes, collective bytes and kernel launches
    of the block it wraps (see module doc); :meth:`report` prices them."""

    def __enter__(self):
        super().__enter__()
        self.flops = self.enter_context(FlopCounterMode(display=False))
        self.dots = self.enter_context(_DotBytes())
        self.coll = self.enter_context(ByteCounter())
        self.launches = self.enter_context(build.recording())
        return self

    def kernels(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for name, cost in self.launches:
            k = out.setdefault(name, {"launches": 0, "flops": 0.0,
                                      "bytes": 0.0})
            k["launches"] += 1
            k["flops"] += cost.flops
            k["bytes"] += cost.hbm_bytes
        return out

    def report(self, device=H100, arg_bytes: Optional[int] = None,
               peak_bytes: Optional[int] = None) -> RooflineReport:
        """The counts priced on ``device``; ``peak_bytes`` (the step's
        peak live bytes) and ``arg_bytes`` (those live before it) give
        ``temp_bytes``."""
        kern = self.kernels()
        temp = None if peak_bytes is None or arg_bytes is None else \
            max(peak_bytes - arg_bytes, 0)
        return RooflineReport(
            dot_flops=float(self.flops.get_total_flops())
            + sum(k["flops"] for k in kern.values()),
            hbm_bytes=float(self.dots.bytes)
            + sum(k["bytes"] for k in kern.values()),
            coll_bytes=float(self.coll.bytes),
            coll_by_kind=dict(self.coll.by_kind), arg_bytes=arg_bytes,
            temp_bytes=temp, device=as_device(device), kernels=kern)


def analyze_traced(fn, *args, device=H100, **kwargs
                   ) -> Tuple[RooflineReport, object]:
    """Roofline terms of one call ``fn(*args, **kwargs)`` (per rank), and
    its result: the counterpart of the reference's ``analyze_compiled``.
    ``device`` is a :class:`~repro_torch.perf.device.DeviceSpec` or a
    preset name, the peaks the three terms are priced against."""
    with StepCounter() as c:
        out = fn(*args, **kwargs)
    return c.report(device), out
