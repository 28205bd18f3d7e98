"""Predicted throughput-scaling curves (the paper's Fig. 7/8 shape).

Composes the α-β plan cost model (:mod:`repro_torch.plan.cost`) with the
analytic compute model (:mod:`repro_torch.analysis.model_math`) to
predict end-to-end training throughput for a described cluster.  On
slow cross-node links the uncompressed-Adam curve flattens as the
all-reduce dominates, while 1-bit compression keeps scaling.

``predicted_scaling`` holds the per-replica batch fixed (weak scaling,
as in Fig. 7) and sweeps the number of pods; each point runs the tuner,
so the compressed schedule picks its topology for that cluster size.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.compression import padded_length
from repro_torch.perf.device import as_device
from repro_torch.plan.cost import ClusterSpec, get_cluster, predict_step_time
from repro_torch.plan.schedules import allreduce_schedule
from repro_torch.plan.tune import autotune, implied_use_kernel


def flat_param_dim(cfg: ArchConfig, tp: int = 1, n_dp: int = 1,
                   block: int = 4096) -> int:
    """Padded flat parameter length a model shard exchanges (the
    training step's ``flat_dim`` of one model rank at ``tp``)."""
    from repro_torch.train.step import flat_dim
    return flat_dim(cfg, n_dp, block, tp)


def predict_point(cfg: ArchConfig, seq_len: int, batch_per_replica: int,
                  spec: ClusterSpec, compressor: str = "onebit",
                  block_size: int = 4096, tp: int = 1,
                  d: Optional[int] = None,
                  use_kernel_options: Optional[Sequence[bool]] = None
                  ) -> Dict[str, object]:
    """One cluster size: predicted step time and throughput of the
    uncompressed-Adam baseline and of the tuned compressed schedule.
    ``use_kernel_options`` pins the tuner's kernel axis (default: the
    value ``spec.device`` implies)."""
    if d is None:
        d = flat_param_dim(cfg, tp=tp, n_dp=spec.n_total, block=block_size)
    shape = InputShape("scaling", seq_len,
                       batch_per_replica * spec.n_total, "train")
    # baseline: uncompressed dp-mean of the full vector (a raw AllReduce
    # carries no compressor compute)
    base_axes = ("pod", "data") if spec.n_outer > 1 else ("data",)
    base_tier = "cross" if spec.n_outer > 1 else "intra"
    d_base = padded_length(d, spec.n_total, block_size)
    base_plan = allreduce_schedule(d_base, spec.n_total, base_axes,
                                   tier=base_tier)
    base = predict_step_time(base_plan, spec, cfg, shape, tp)

    from repro_torch.optim.compressors import get_compressor
    if use_kernel_options is None:
        use_kernel_options = (implied_use_kernel(spec, compressor),)
    tuned = autotune(spec, d, compressors=[compressor],
                     block_sizes=[block_size],
                     use_kernel_options=use_kernel_options)
    # report with the objective the tuner selected on: the best
    # candidate's compressor (kernel path included) charges its compute
    best_comp = get_compressor(compressor, block_size=block_size)
    comp = predict_step_time(tuned.best.plan, spec, cfg, shape, tp,
                             comp=best_comp,
                             use_kernel=tuned.best.use_kernel)
    return {
        "n_pods": spec.n_outer, "n_devices": spec.n_total * tp,
        "cluster": spec.name, "topology": tuned.best.topology,
        "d": d,
        "t_step_adam": base["t_step"],
        "t_step_compressed": comp["t_step"],
        "t_comm_adam": base["t_comm"],
        "t_comm_compressed": comp["t_comm"],
        "t_exchange_compute": comp["t_exchange_compute"],
        "t_compute": comp["t_compute"],
        "tokens_per_s_adam": base.get("tokens_per_s", 0.0),
        "tokens_per_s_compressed": comp.get("tokens_per_s", 0.0),
        "speedup": base["t_step"] / comp["t_step"],
    }


def predicted_scaling(cfg: ArchConfig, seq_len: int, batch_per_replica: int,
                      cluster: str, n_inner: int,
                      pod_counts: Sequence[int] = (1, 2, 4, 8, 16),
                      compressor: str = "onebit", block_size: int = 4096,
                      tp: int = 1, device="h100-sxm",
                      use_kernel_options: Optional[Sequence[bool]] = None
                      ) -> Dict[int, Dict[str, object]]:
    """Weak-scaling sweep over pod counts on a named cluster preset.
    ``device`` (a ``repro_torch.perf`` preset, ``measured:<path>`` or a
    DeviceSpec) sets the 6ND compute term and the tuner's compute
    pricing.  Returns ``{n_pods: predict_point(...)}``."""
    d = flat_param_dim(cfg, tp=tp, n_dp=n_inner * max(pod_counts),
                       block=block_size)
    dev = as_device(device)
    out = {}
    for n in pod_counts:
        spec = get_cluster(cluster, n_inner=n_inner, n_outer=n, device=dev)
        out[n] = predict_point(cfg, seq_len, batch_per_replica, spec,
                               compressor=compressor,
                               block_size=block_size, tp=tp, d=d,
                               use_kernel_options=use_kernel_options)
    return out


def comm_fraction(plan, spec: ClusterSpec, cfg: ArchConfig,
                  shape: InputShape, tp: int = 1) -> float:
    """Fraction of the predicted step time spent in the exchange."""
    p = predict_step_time(plan, spec, cfg, shape, tp)
    return p["t_comm"] / p["t_step"] if p["t_step"] > 0 else 0.0
