"""Training entry point of the port: the optimizer family on every arch
the registry holds (``--arch``: the BERT encoders, the dense, MoE, SSM and
hybrid decoders, the audio and VLM stubs; ``NAME-smoke`` for the reduced
config).

Runs on the card unless asked for the CPU (``--device cpu``); asking for
``cuda`` without a card raises.  One process is one rank of the mesh: run
it alone (n_dp = 1), or under ``torchrun`` (NCCL on cuda, gloo on cpu),
where the mesh defaults to one dp axis over ``WORLD_SIZE`` ranks.

  python -m repro_torch.launch.train --arch bert-large --steps 6 \\
      --warmup-steps 3 --batch 16 --seq 128 --recipe onebit_lamb
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch bert-large
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
      --arch bert-large-smoke --mesh 2x2x1 --topology hier --pipeline 2 \\
      --overlap-bwd on
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
      --arch internlm2-1.8b-smoke --mesh 2x2

``--mesh`` takes the reference's grammar (``N``; ``NxT``: N dp ranks x a
model axis of T; ``PxNxT``: P pods of N ranks, x T).  With T > 1 each
model rank holds its shard of every tensor-parallel leaf (the reference's
global tree at tp = T, drawn leaf by leaf from the seed and cut), runs
the model's Megatron collectives over its model group, and runs the
optimizer's warmup all-reduce and compressed exchange over its own dp
group, on its own flat vector (``models.common``, ``launch.mesh``).
``--topology hier`` runs the two-level exchange (on a one-pod mesh it is
the flat one, and the printed plan says ``flat/...``); ``--pipeline N``
splits the compressed exchange into N block-aligned buckets (clamped to
the alignment units); ``--overlap-bwd on`` issues each bucket's exchange
from inside backward on compressed steps that synchronise, with more than
one bucket (every other step runs serially; each step's record says
which).  ``auto`` for any of them is resolved by one joint search of the
plan tuner (``repro_torch.plan.autotune``) against ``--cluster`` (a link preset or
``measured:<comm_sweep.json>``) and ``--device-spec`` (a device preset,
default ``h100-sxm`` on cuda and ``cpu-host`` on cpu, or
``measured:<kernel_sweep.json>``); it prints the pick and the priced
table.  The recipes ``onebit_adam_autotopo`` and
``onebit_adam_pipelined`` set ``auto`` themselves.  The kernel axis has
no flag: a CUDA tensor takes the port's kernels, so the device spec
implies it.

A recipe (``--recipe``, ``repro_torch.configs.list_optim_recipes``) names
the optimizer, the compressor, their keyword arguments and the warmup
switch; ``--optimizer`` / ``--compressor`` override its names.  The state
layout follows the optimizer: ``local`` when it may skip syncs (0/1
Adam's 0-bit steps; ``sync_due`` is asked once per compression-stage
step), else ``replicated``.  ``--ckpt PATH`` saves the parameters and
optimizer state every 100 steps and at the end, in the reference's
archive format; ``--resume PATH`` continues from one at its step;
``--stage`` forces every step's stage, synchronises every step and
leaves the warmup switch unfed, as the reference's does.

Observability (``repro_torch.obs``; every piece a no-op when off):

  * ``--telemetry DIR`` writes typed JSONL events to
    ``DIR/telemetry.jsonl`` (rank r > 0: ``telemetry_rank<r>.jsonl``):
    ``run_meta``, the ``plan`` events of both exchanges, ``step`` events
    drained in batches (``--log-every N``: one device-to-host copy a
    window, and a ``train.window`` span whose ``dur / n`` is the time a
    step), ``transition`` and ``warning`` events, and the executors'
    ``obs::`` trace ranges; ``--drift-probe`` times the compressed
    exchange's collectives on the real process groups first and runs the
    cost-model drift monitor (one rank has nothing to probe).  Fold a log
    with ``python -m repro_torch.obs.report DIR/telemetry.jsonl``.
  * ``--memory on`` (with ``--telemetry``): the predicted per-rank ledger,
    a live sample every log window, and the caching allocator's peak
    around the first step of each step program (``warmup``,
    ``compressed``; on the card), attributed onto the ledger with an
    explicit residual; ``DIR/memory_ledger.json``.
  * ``--audit on``: every ``--audit-every``-th compression-stage step
    first runs the audit probe on the step's batch (its own gradient
    buffer; ``fidelity`` and ``health`` events).
  * ``--profile DIR``: a ``torch.profiler`` trace of the last
    ``--profile-steps`` steps (``DIR/trace_rank<r>.json``), folded onto
    the plan grid (a ``profile`` event), and ``DIR/BENCH_<--bench>.json``.

``run(...)`` is the entry point the tests and ``chip_smoke.py`` drive: it
returns the per-step history (loss, stage, sync, metrics, and with
``log_every=1``, its default, each step's time) and the kernel launch
counts of the run.  It prints the run's plan first.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import (get_config, get_optim_recipe,
                                  list_optim_recipes)
from repro_torch.configs.base import InputShape
from repro_torch.convert import (flat_from_params, params_from_flat,
                                 shard_params, unshard_params)
from repro_torch.data import SyntheticStream
from repro_torch.kernels import build
from repro_torch.launch.mesh import (build_mesh, mesh_axes, parse_mesh,
                                     pod_split)
from repro_torch.models.transformer import (global_leaf_shapes, init_params,
                                            leaf_shapes, param_specs)
from repro_torch.obs import (AUDIT_MODES, MEMORY_MODES, FiniteGuard,
                             HealthMonitor, MetricBuffer, Tracer, as_sink,
                             make_audit_probe, set_tracing)
from repro_torch.optim import WarmupSwitch, get_optimizer
from repro_torch.plan import autotune, get_cluster
from repro_torch.plan.schedules import (allreduce_schedule, flat_schedule,
                                        hier_schedule, needs_outer_ef)
from repro_torch.state import bucket_sizes_for
from repro_torch.state.checkpoint import load_train_state, save_train_state
from repro_torch.train.step import (exchange_axes, flat_dim,
                                    init_train_state, overlap_applies,
                                    state_layout_ctx, train_step)

CKPT_EVERY = 100


def lr_schedule(step: int, base_lr: float, lr_warmup: int,
                decay: float = 0.99, decay_every: int = 520) -> float:
    """The paper's BERT schedule: linear warmup then step decay."""
    if step < lr_warmup:
        return base_lr * (step + 1) / max(lr_warmup, 1)
    return base_lr * (decay ** ((step - lr_warmup) // decay_every))


def resolve_device(device: str) -> torch.device:
    """``cuda`` (this rank's card), ``cpu``, or ``meta`` (the dry run,
    ``launch.dryrun``: shapes only); cuda without a card raises."""
    if device in ("cpu", "meta"):
        return torch.device(device)
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    return dev


def bwd_ready_fn(cfg, batch: int, seq: int, device, tp: int = 1):
    """``(ready_times_fn, t_bwd)``: a closure ``(bucket_offsets, d_pad)
    -> per-bucket ready seconds`` from the analytic reverse sweep
    (``analysis.model_math``), and the whole backward's seconds."""
    from repro_torch.analysis.model_math import (bwd_ready_times,
                                                 bwd_total_time)
    shape = InputShape("custom", seq, batch, "train")

    def fn(offsets, d_pad):
        return bwd_ready_times(offsets, d_pad, cfg, shape, device, tp)

    return fn, bwd_total_time(cfg, shape, device, tp)


def resolve_schedule(topology, pipeline, overlap_bwd,
                     cluster: str = "ethernet-10g", cfg=None,
                     dp_sizes=(1,), compressor: str = "onebit",
                     block_size: int = 4096, compressor_kwargs=None,
                     device_spec="h100-sxm", batch: int = 8,
                     seq: int = 128, verbose: bool = True,
                     tp: int = 1) -> tuple:
    """``(topology, n_buckets, overlap, tuned)`` from the options'
    spellings: a topology name or ``"auto"``; ``"off"``, a bucket count
    or ``"auto"``; ``"off"``, ``"on"`` or ``"auto"``.

    The ``auto`` axes are resolved by one joint ``autotune`` search
    (``tuned`` is its TuneResult, else None): the mesh's dp sizes fix
    the pod split (the leading of two axes is the pod axis), ``cluster``
    the links, ``device_spec`` the compute roofline and the kernel axis;
    the compressor and block size are pinned.  Explicit values pin their
    axis.  Overlap candidates are priced on the analytic backward ready
    times for (``batch``, ``seq``) and charged only the exchange time
    exposed beyond backward.  ``tp``: the model axis (each model rank
    exchanges its own flat vector)."""
    if topology not in ("flat", "hier", "auto"):
        raise ValueError(f"topology must be 'flat', 'hier' or 'auto', got "
                         f"{topology!r}")
    if overlap_bwd not in ("off", "on", "auto"):
        raise ValueError(f"overlap_bwd must be 'off', 'on' or 'auto', got "
                         f"{overlap_bwd!r}")
    pipe_auto, topo_auto = pipeline == "auto", topology == "auto"
    ob_auto = overlap_bwd == "auto"
    n_buckets = 1 if pipeline in ("off", "auto") else int(pipeline)
    if n_buckets < 1:
        raise ValueError(f"pipeline must be 'off', 'auto' or a count >= 1, "
                         f"got {pipeline!r}")
    overlap = overlap_bwd == "on"
    if not (topo_auto or pipe_auto or ob_auto):
        return topology, n_buckets, overlap, None
    _, _, n_inner, n_outer = pod_split(mesh_axes(dp_sizes), dp_sizes)
    spec = get_cluster(cluster, n_inner=n_inner, n_outer=n_outer,
                       device=device_spec)
    d = flat_dim(cfg, n_inner * n_outer, block_size, tp)
    if topo_auto:
        topos = ("flat", "hier") if n_outer > 1 else ("flat",)
    else:
        # hier on one pod runs flat: price what runs
        topos = (topology if topology != "hier" or n_outer > 1
                 else "flat",)
    # forced on still prices overlap off, so a serial pipeline keeps a
    # valid candidate
    overlap_opts = (False, True) if (ob_auto or overlap) else (False,)
    ready_fn, t_bwd = bwd_ready_fn(cfg, batch, seq, spec.device, tp)
    tuned = autotune(spec, d, compressors=[compressor],
                     block_sizes=[block_size], topologies=topos,
                     compressor_kwargs=compressor_kwargs,
                     n_buckets_options=(1, 2, 4, 8) if pipe_auto
                     else (n_buckets,),
                     overlap_bwd_options=overlap_opts,
                     t_bwd=t_bwd, ready_times_fn=ready_fn)
    best = tuned.best
    if verbose:
        print(f"[auto-schedule] cluster={spec.name} "
              f"({n_outer} pod(s) x {n_inner} dp, "
              f"device={spec.device.name}): picked "
              f"{best.topology!r} x {best.n_buckets} bucket(s), "
              f"kernels={'cuda' if best.use_kernel else 'plain'}, "
              f"overlap-bwd={'on' if best.overlap_bwd else 'off'} "
              f"(t_exchange {best.t_exchange*1e3:.3f} ms, compute "
              f"{best.t_compute*1e3:.3f} ms, "
              f"DCI {best.dci_bytes_per_pod} B/pod)", flush=True)
        for c in tuned.table:
            if c.valid:
                print(f"    {c.topology:5s} buckets={c.n_buckets} "
                      f"kernels={'cuda' if c.use_kernel else 'plain':5s} "
                      f"overlap={'on' if c.overlap_bwd else 'off':3s} "
                      f"t={c.t_exchange*1e3:.3f} ms "
                      f"(compute {c.t_compute*1e3:.3f}) "
                      f"dci={c.dci_bytes_per_pod}", flush=True)
    out_nb = best.n_buckets if pipe_auto else n_buckets
    out_ob = best.overlap_bwd if ob_auto else overlap
    return (best.topology if topo_auto else topology, out_nb,
            out_ob and out_nb > 1, tuned)


def _mesh_dims(mesh) -> tuple:
    """(dp sizes, model axis size) of a built ``DpMesh`` or a ``--mesh``
    spelling."""
    if hasattr(mesh, "sizes"):
        return tuple(mesh.sizes), mesh.tp
    return parse_mesh(mesh)


def resolve_topology(topology: str, cluster: str, cfg, mesh,
                     compressor: str = "onebit", block_size: int = 4096,
                     compressor_kwargs=None, verbose: bool = True,
                     **kw) -> str:
    """``topology="auto"`` with serial execution (see
    :func:`resolve_schedule`, which takes ``kw``: ``device_spec``,
    ``batch``, ``seq``); ``mesh`` is a ``DpMesh`` or a ``--mesh``
    spelling."""
    dp_sizes, tp = _mesh_dims(mesh)
    return resolve_schedule(topology, "off", "off", cluster, cfg, dp_sizes,
                            compressor, block_size, compressor_kwargs,
                            verbose=verbose, tp=tp, **kw)[0]


def resolve_pipeline(pipeline, topology: str, cluster: str, cfg, mesh,
                     compressor: str = "onebit", block_size: int = 4096,
                     compressor_kwargs=None, verbose: bool = True,
                     **kw) -> int:
    """``pipeline="auto"`` with the topology pinned and no backward
    overlap (see :func:`resolve_topology`)."""
    dp_sizes, tp = _mesh_dims(mesh)
    return resolve_schedule(topology, pipeline, "off", cluster, cfg,
                            dp_sizes, compressor, block_size,
                            compressor_kwargs, verbose=verbose, tp=tp,
                            **kw)[1]


def run_plans(optim, d_pad: int, dp_axes, dp_sizes, topology: str):
    """The (warmup, compressed) CommPlans this run executes, built on the
    host as the step builds them (``hier`` on one pod is flat)."""
    n_dp = math.prod(dp_sizes)
    axes = tuple(dp_axes) if n_dp > 1 else ()
    inner, outer, n_inner, n_outer = pod_split(axes, dp_sizes)
    comp = optim.compressor
    warm = allreduce_schedule(d_pad, n_dp, axes,
                              tier="cross" if n_outer > 1 else "intra")
    if topology == "hier" and n_outer > 1:
        plan = hier_schedule(comp, d_pad, n_inner, n_outer, inner, outer,
                             outer_ef=needs_outer_ef(comp))
    else:
        plan = flat_schedule(comp, d_pad, n_dp, axes)
    return warm, plan


def plan_ready_times(cfg, d: int, n_dp: int, block_size: int,
                     n_buckets: int, device, batch: int, seq: int,
                     tp: int = 1):
    """Per-bucket predicted backward ready times of this run's bucket
    partition (None unless bucketed) and the backward's seconds: the list
    the plan telemetry, the memory ledger and the profile fold share."""
    if n_buckets <= 1:
        return None, 0.0
    from repro_torch.pipeline import Bucketer
    ready_fn, t_bwd = bwd_ready_fn(cfg, batch, seq, device, tp)
    bk = Bucketer.for_exchange(d, max(n_dp, 1), block_size, n_buckets)
    return [float(r) for r in ready_fn(tuple(bk.offsets), d)], t_bwd


def _cluster(cluster: str, dp_sizes, device_spec):
    _, _, n_inner, n_outer = pod_split(mesh_axes(dp_sizes), dp_sizes)
    return get_cluster(cluster, n_inner=n_inner, n_outer=n_outer,
                       device=device_spec), n_inner * n_outer


def emit_plan_telemetry(sink, tracer, optim, cfg, plans, dp_sizes,
                        n_buckets: int, block_size: int, cluster: str,
                        device_spec, dev, drift_probe: bool = False,
                        telemetry_dir: Optional[str] = None,
                        overlap_bwd: bool = False, batch: int = 8,
                        seq: int = 128, tp: int = 1) -> None:
    """The run's ``plan`` events (per-tier bytes and predicted α-β times
    of the (warmup, compressed) ``plans``; under ``overlap_bwd`` the
    per-bucket backward ready times too) and, with ``drift_probe``, each
    compressed-exchange collective timed on the process groups of its
    axes and the drift monitor over the samples (a recalibration JSON in
    the telemetry dir when drift exceeds the threshold).  Every rank
    calls it: the probe's collectives are real."""
    from repro_torch.obs.drift import DriftMonitor, probe_plan
    from repro_torch.plan import cross_pod_bytes, plan_time
    spec, n_dp = _cluster(cluster, dp_sizes, device_spec)
    warm, comp_plan = plans
    for stage, p, nb in (("warmup", warm, 1),
                         ("compressed", comp_plan, n_buckets)):
        extra = {}
        if overlap_bwd and stage == "compressed":
            ready, t_bwd = plan_ready_times(cfg, p.d, n_dp, block_size, nb,
                                            spec.device, batch, seq, tp)
            if ready is not None:
                extra = {"overlap_bwd": True, "t_bwd": float(t_bwd),
                         "ready_times": ready}
        sink.emit("plan", name=p.name, stage=stage, d=p.d,
                  intra_hlo_bytes=float(p.hlo_bytes("intra")),
                  cross_hlo_bytes=float(p.hlo_bytes("cross")),
                  n_buckets=nb, wire_send_bytes=float(p.wire_send_bytes()),
                  dci_bytes_per_pod=float(cross_pod_bytes(p, spec)),
                  t_predicted=float(plan_time(p, spec)), **extra)
    if not drift_probe:
        return
    mon = DriftMonitor(spec)
    with tracer.span("drift.probe"):
        samples = probe_plan(comp_plan, dev)
    if not samples:
        print("[drift] one rank: the compressed exchange moves no bytes, "
              "nothing to probe", flush=True)
        return
    for smp in samples:
        mon.observe(smp.op_kind, smp.tier, smp.n, smp.payload_bytes,
                    smp.seconds)
        sink.emit("span", name=f"probe::{smp.op_kind}@{smp.tier}",
                  stream=smp.tier, dur=smp.seconds, op_kind=smp.op_kind,
                  tier=smp.tier, payload_bytes=smp.payload_bytes)
    recal_path = (os.path.join(telemetry_dir, os.path.basename(
        sink.path).replace("telemetry", "recalibration").replace(
        ".jsonl", ".json")) if telemetry_dir else None)
    for etype, fields in mon.events(emit_recal_path=recal_path):
        sink.emit(etype, **fields)
    for pair in mon.drifting:
        print(f"[drift] {pair[0]}@{pair[1]} outside the cost model's "
              f"{mon.threshold:.0%} band"
              + (f" — recalibration written to {recal_path}"
                 if recal_path else ""), flush=True)


def ready_order_rows(fold_intervals, predicted_intervals, ready):
    """The measured-vs-predicted ready-order table: one row per bucket
    with its predicted backward ready time and the first collective start
    on each side."""
    def first_starts(intervals):
        first = {}
        for iv in intervals:
            b = iv.get("bucket")
            if b is None or iv.get("phase") == "bwd":
                continue
            t = float(iv["t_start"])
            if b not in first or t < first[b]:
                first[b] = t
        return first
    meas = first_starts(fold_intervals)
    pred = first_starts(predicted_intervals)
    return [{"bucket": int(b),
             "ready_predicted": (float(ready[b])
                                 if ready and b < len(ready) else 0.0),
             "first_start_predicted": pred.get(b, 0.0),
             "first_start_measured": meas.get(b, 0.0)}
            for b in sorted(set(meas) | set(pred))]


def fold_profile_window(trace_path: str, n_steps: int, optim, cfg, plans,
                        dp_sizes, n_buckets: int, block_size: int,
                        cluster: str, device_spec, device: str,
                        stage: str = "compressed",
                        overlap_bwd: bool = False, batch: int = 8,
                        seq: int = 128, tp: int = 1) -> dict:
    """Fold the captured trace onto the plan grid and build the
    ``profile`` event's fields (:func:`repro_torch.obs.profile.attribution`):
    the measured cells, the overlap audit against the predicted
    ``pipeline_breakdown`` of this run's lowered exchange (the four-stream
    schedule under ``overlap_bwd``), bytes a step from the executed
    plan, and under overlap the per-bucket ``ready_order`` table."""
    from repro_torch.obs import profile as prof
    from repro_torch.pipeline import Bucketer, lower_to_pipelined
    from repro_torch.plan import pipeline_breakdown
    spec, n_dp = _cluster(cluster, dp_sizes, device_spec)
    warm, comp_plan = plans
    plan = comp_plan if stage == "compressed" else warm
    comp = optim.compressor if stage == "compressed" else None
    nb = n_buckets if stage == "compressed" else 1
    bucketer = Bucketer.for_exchange(plan.d, n_dp, block_size, nb)
    ready = None
    if overlap_bwd and stage == "compressed":
        ready, _ = plan_ready_times(cfg, plan.d, n_dp, block_size,
                                    bucketer.n_buckets, spec.device, batch,
                                    seq, tp)
    predicted = pipeline_breakdown(
        lower_to_pipelined(plan, comp, bucketer, use_kernel=(
            spec.device.runs_kernels and comp is not None
            and comp.has_kernel)),
        spec, ready=ready)
    fold = prof.fold_profile(trace_path, device=device)
    fields = prof.attribution(fold, n_steps=n_steps, predicted=predicted,
                              bytes_per_step=float(plan.hlo_bytes()),
                              source="launch.train")
    if ready is not None:
        fields["ready_order"] = ready_order_rows(
            fold["intervals"], predicted["intervals"], ready)
    return fields


def build_memory_ledger(optim, cfg, comp_plan, dp_sizes, topology: str,
                        n_buckets: int, block_size: int, cluster: str,
                        device_spec, layout: str, batch: int, seq: int,
                        overlap_bwd: bool = False, tp: int = 1):
    """The predicted per-rank :class:`~repro_torch.obs.mem.MemoryLedger`
    of this run, priced against the device spec's capacity; under
    ``overlap_bwd`` the wire watermark is taken over the four-stream
    schedule."""
    from repro_torch.obs.mem import capacity_of, predict_ledger
    spec, n_dp = _cluster(cluster, dp_sizes, device_spec)
    ready = None
    if overlap_bwd:
        ready, _ = plan_ready_times(cfg, comp_plan.d, n_dp, block_size,
                                    n_buckets, spec.device, batch, seq, tp)
    return predict_ledger(
        cfg, dp_sizes, optim=optim, layout=layout, topology=topology,
        block=block_size, n_buckets=n_buckets, batch_global=batch,
        seq=seq, plan=comp_plan, spec=spec,
        capacity_bytes=capacity_of(spec.device), ready=ready, tp=tp)


def emit_memory_attribution(programs: dict, sink, ledger,
                            telemetry_dir: Optional[str] = None):
    """The measured side of the ledger: one ``memory`` event
    (``kind="compiled"``) per measured step program — its output and
    temporary bytes attributed onto the predicted categories with an
    explicit residual — and ``memory_ledger.json`` in the telemetry dir.
    Returns the largest program's
    :class:`~repro_torch.obs.mem.CompiledMemory` (None when nothing was
    measured: the CPU has no allocator statistics)."""
    from repro_torch.obs.mem import attribution_event_fields
    biggest, dump = None, []
    for cm in programs.values():
        fields = attribution_event_fields(ledger, cm)
        sink.emit("memory", **fields)
        dump.append(fields)
        if biggest is None or \
                cm.per_device_bytes > biggest.per_device_bytes:
            biggest = cm
    if telemetry_dir:
        name = os.path.basename(sink.path).replace(
            "telemetry", "memory_ledger").replace(".jsonl", ".json")
        with open(os.path.join(telemetry_dir, name), "w") as f:
            json.dump({"predicted": ledger.summary(), "compiled": dump}, f,
                      indent=2)
    return biggest


def emit_profile_ledger(trace_path: str, profile_dir: str, sink, optim,
                        cfg, plans, dp_sizes, n_buckets: int,
                        block_size: int, cluster: str, device_spec,
                        device: str, n_steps: int, stage: str,
                        bench: Optional[str], arch: str, rank: int = 0,
                        extra_metrics: Optional[dict] = None,
                        overlap_bwd: bool = False, batch: int = 8,
                        seq: int = 128, tp: int = 1) -> dict:
    """The fold (:func:`fold_profile_window`), the ``profile`` event and,
    on rank 0, the ``BENCH_<name>.json`` ledger record."""
    from repro_torch.obs.bench import bench_record, write_ledger
    fields = fold_profile_window(trace_path, n_steps, optim, cfg, plans,
                                 dp_sizes, n_buckets, block_size, cluster,
                                 device_spec, device, stage=stage,
                                 overlap_bwd=overlap_bwd, batch=batch,
                                 seq=seq, tp=tp)
    sink.emit("profile", **fields)
    metrics = {k: float(fields[k]) for k in
               ("s_per_step", "comm_fraction", "overlap_efficiency",
                "exposed_comm_s", "roofline_fraction", "t_window",
                "t_attributed", "t_residual", "bytes_per_step")
               if k in fields}
    metrics["n_cells"] = int(fields["n_cells"])
    if fields.get("t_window"):
        metrics["attributed_fraction"] = (fields["t_attributed"]
                                          / fields["t_window"])
    if extra_metrics:
        metrics.update({k: float(v) for k, v in extra_metrics.items()})
    name = bench or "train"
    ledger_path = os.path.join(profile_dir, f"BENCH_{name}.json")
    if rank == 0:
        rec = bench_record(name, config=arch, mesh=[int(s) for s in
                                                    dp_sizes],
                           pipeline=int(n_buckets),
                           kernels=device == "cuda", metrics=metrics)
        write_ledger(ledger_path, [rec],
                     meta={"source": "repro_torch.launch.train",
                           "cluster": cluster, "device": device,
                           "arch": arch, "stage": stage})
    print(f"profile: {fields['n_cells']} grid cells, "
          f"{fields['t_attributed']:.3f}s attributed + "
          f"{fields['t_residual']:.3f}s residual of "
          f"{fields['t_window']:.3f}s window ({n_steps} steps)"
          + (f"; ledger -> {ledger_path}" if rank == 0 else ""),
          flush=True)
    return fields


def run(arch: str = "bert-base-smoke", recipe: str = "onebit_adam",
        steps: int = 100, warmup_steps: Optional[int] = None,
        batch: int = 8, seq: int = 128, block_size: int = 4096,
        lr: float = 1e-3, lr_warmup: int = 20, seed: int = 0,
        device: str = "cuda", verbose: bool = True,
        optimizer: Optional[str] = None, compressor: Optional[str] = None,
        ckpt: Optional[str] = None, resume: Optional[str] = None,
        stage_override: Optional[str] = None, mesh=None,
        topology: Optional[str] = None, pipeline=None,
        overlap_bwd: str = "off", cluster: str = "ethernet-10g",
        device_spec=None, telemetry: Optional[str] = None,
        log_every: int = 1, log_file: Optional[str] = None,
        profile: Optional[str] = None, profile_steps: int = 4,
        memory: str = "off", audit: str = "off", audit_every: int = 10,
        drift_probe: bool = False, bench: Optional[str] = None,
        seq_parallel: bool = False, auto_warmup: bool = False) -> dict:
    """Train until step ``steps``; returns ``{"history", "launches", "d",
    "d_pad", "state", "optimizer", "layout", "start_step",
    "checkpoint_s", "topology", "n_buckets", "overlap_bwd", "plan",
    "schedule", "tp"}`` (``checkpoint_s``: the seconds of the resume's load and
    the last save, host clock; ``plan``: the compressed exchange's plan
    name; ``schedule``: the tuner's pick, a ``plan.tune.Candidate``, when
    an axis was ``auto``, else None).

    ``warmup_steps`` is the manual T_w; ``None``, ``auto_warmup`` or an
    ``auto`` recipe selects the paper's Sec. 7.1 variance-ratio rule, as
    in the reference's ``run``.  ``batch`` is the global batch, split over
    the dp ranks of an initialised process group (the model ranks of one
    dp rank take the same rows).  ``mesh`` (default: one dp axis over the
    process group) is a ``--mesh`` spelling; ``seq_parallel`` runs a model axis
    above 1 with Megatron sequence parallelism; ``topology``
    and ``pipeline`` default to the recipe's (``"flat"`` and ``"off"``
    but for the auto recipes).  ``auto`` values are resolved by the plan
    tuner (:func:`resolve_schedule`) against ``cluster`` and
    ``device_spec`` (a DeviceSpec, a preset name or
    ``measured:<path>``; default by ``device``).  ``resume``
    starts at the checkpoint's step; the compression-stage step count
    that drives ``sync_due`` resumes with it (manual T_w; the auto rule's
    monitor is not checkpointed, as in the reference).

    Observability (see the module docstring): ``telemetry`` (a directory),
    ``log_every`` (steps a metric window: its records are fetched in one
    copy; with 1, the default, each record carries its step's ``ms``,
    with more none does and the window's ``train.window`` span times the
    steps), ``log_file`` (the history as JSON), ``profile`` (a directory)
    and ``profile_steps``, ``memory`` and ``audit`` (``"off"`` /
    ``"on"``), ``audit_every``, ``drift_probe`` and ``bench`` (the
    ledger's name).  The result gains ``"telemetry"`` (the log's path or
    None) and ``"profile"`` (the ``profile`` event's fields or None)."""
    if audit not in AUDIT_MODES:
        raise ValueError(f"audit must be one of {AUDIT_MODES}, got "
                         f"{audit!r}")
    if memory not in MEMORY_MODES:
        raise ValueError(f"memory must be one of {MEMORY_MODES}, got "
                         f"{memory!r}")
    if log_every < 1:
        raise ValueError(f"log_every must be >= 1, got {log_every}")
    dev = resolve_device(device)
    device_spec = device_spec or ("cpu-host" if device == "cpu"
                                  else "h100-sxm")
    cfg = get_config(arch)
    spec = get_optim_recipe(recipe)
    if optimizer:
        spec = dataclasses.replace(spec, optimizer=optimizer)
    if compressor:
        spec = dataclasses.replace(spec, compressor=compressor)
    spec = dataclasses.replace(spec, block_size=block_size)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    dpm = build_mesh(mesh if mesh is not None else str(world))
    n_dp, tp, tp_axes = dpm.n_dp, dpm.tp, dpm.tp_axes
    dp_rank, model_rank = dpm.dp_rank, dpm.model_rank
    topology, n_buckets, overlap, tuned = resolve_schedule(
        spec.topology if topology is None else topology,
        spec.pipeline if pipeline is None else pipeline, overlap_bwd,
        cluster=cluster, cfg=cfg, dp_sizes=dpm.sizes,
        compressor=spec.compressor, block_size=block_size,
        compressor_kwargs=spec.compressor_kwargs,
        device_spec=device_spec, batch=batch, seq=seq,
        verbose=verbose and rank == 0, tp=tp)
    dp_axes, pod_axes, n_inner, n_outer = pod_split(dpm.axes, dpm.sizes) \
        if n_dp > 1 else ((), (), 1, 1)
    if topology == "hier" and n_outer == 1:
        topology = "flat"           # one pod: the reference's step does so
    comp_kwargs = dict(spec.compressor_kwargs or {})
    comp_kwargs.setdefault("block_size", block_size)
    optim = get_optimizer(spec.optimizer, compressor=spec.compressor,
                          compressor_kwargs=comp_kwargs,
                          **(spec.optimizer_kwargs or {}))
    layout = "local" if optim.may_skip_sync else "replicated"
    hier = topology == "hier"
    d_pad = flat_dim(cfg, n_dp, block_size, tp)
    # the bucket count the executor runs (clamped to the alignment units):
    # it fixes the EF slots' layout that checkpoints re-key
    n_buckets = len(bucket_sizes_for(d_pad, n_dp, block_size, n_buckets))
    warm_plan, comp_plan = run_plans(optim, d_pad, dpm.axes, dpm.sizes,
                                     topology)
    plan_name = comp_plan.name if n_buckets == 1 else \
        f"pipe({comp_plan.name})x{n_buckets}"
    if verbose and rank == 0:
        print(f"[plan] mesh {'x'.join(map(str, dpm.sizes))}"
              + (f"x{tp} {dpm.axes + tp_axes}" if tp > 1
                 else f" {dpm.axes}")
              + f" | warmup {warm_plan.name} | compressed "
              f"{plan_name} | overlap-bwd "
              f"{'on' if overlap and n_buckets > 1 else 'off'}"
              + (" (needs more than one bucket)"
                 if overlap and n_buckets == 1 else "")
              # the buckets of a pipelined plan move the same bytes
              + f" | wire bytes a rank and step: warmup "
              f"{warm_plan.wire_send_bytes():.0f}, compressed "
              f"{comp_plan.wire_send_bytes():.0f}", flush=True)
    # every model rank draws the global tree leaf by leaf and keeps its
    # shard: one seed, one global model
    params = init_params(cfg, torch.Generator().manual_seed(seed), dev,
                         tp=tp, rank=model_rank if tp > 1 else None)
    ts = init_train_state(cfg, params, optim, block_size, n_dp, dev,
                          layout=layout, n_inner=n_inner if hier else None,
                          ctx=dpm.parallel_ctx(), seq_parallel=seq_parallel)
    del params
    slots = optim.state_slots(layout)
    state_ctx = state_layout_ctx(cfg, dpm, block_size, topology)
    shapes = leaf_shapes(cfg, tp)
    specs = param_specs(cfg)
    start_step, io_s = 0, {}
    if resume:
        t0 = time.perf_counter()
        (params, ts.opt), start_step = load_train_state(
            resume, {p: torch.zeros(()).expand(shp)
                     for p, shp in global_leaf_shapes(cfg, tp)}, ts.opt,
            slots=slots, ctx=state_ctx, n_buckets=n_buckets,
            block=block_size, rank=dp_rank, model_rank=model_rank)
        with torch.no_grad():
            ts.x[:ts.d].copy_(flat_from_params(
                shard_params(params, specs, tp, model_rank)))
        del params
        io_s["load"] = time.perf_counter() - t0
        if verbose and rank == 0:
            print(f"resumed from {resume} at step {start_step}", flush=True)

    def global_params():
        """The global tree: every model rank's flat vector gathered over
        the model group, cut into its shards and joined."""
        if tp == 1:
            return params_from_flat(ts.x, shapes)
        from repro_torch.plan.executor import all_gather_into, group_of
        flat = torch.empty((tp, ts.x.shape[0]), dtype=ts.x.dtype,
                           device=ts.x.device)
        all_gather_into(flat.view(-1), ts.x, group=group_of(tp_axes))
        return unshard_params([params_from_flat(f, shapes) for f in flat],
                              specs)

    def save(step: int) -> None:
        t0 = time.perf_counter()
        save_train_state(ckpt, global_params(), ts.opt, step,
                         slots=slots, ctx=state_ctx, n_buckets=n_buckets,
                         block=block_size, dp_axes=dpm.axes if n_dp > 1
                         else (), tp_axes=tp_axes)
        io_s["save"] = time.perf_counter() - t0

    stream = SyntheticStream(cfg, InputShape("custom", seq, batch, "train"),
                             seed=seed, shard=dp_rank, n_shards=n_dp,
                             device=dev)
    manual = warmup_steps is not None and not auto_warmup \
        and spec.switch_mode != "auto"
    switch = WarmupSwitch(
        mode="steps" if manual else "auto",
        warmup_steps=warmup_steps if warmup_steps is not None else 0,
        b2=optim.b2, threshold=spec.var_freeze_threshold,
        lr_warmup_steps=lr_warmup)
    # compression-stage step index (drives sync_due)
    comp_step = sum(switch.compressed(s) for s in range(start_step)) \
        if manual else 0

    # --- telemetry (repro_torch.obs; every piece a no-op when off) -------
    sink = as_sink(telemetry, filename="telemetry.jsonl" if rank == 0
                   else f"telemetry_rank{rank}.jsonl")
    tracer = Tracer(sink)
    # the obs:: ranges and the step's spans: only a profiler reads them,
    # and each costs a dispatcher call a step while on
    set_tracing(profile is not None)
    plans = (warm_plan, comp_plan)
    overlap_on = overlap and n_buckets > 1
    if sink.enabled:
        sink.emit("run_meta", optimizer=spec.optimizer,
                  compressor=spec.compressor, topology=topology,
                  n_buckets=n_buckets, arch=arch, layout=layout,
                  use_kernel=dev.type == "cuda", overlap_bwd=overlap_on,
                  mesh=list(dpm.sizes), steps=steps, block_size=block_size,
                  cluster=cluster, device=device, seed=seed, recipe=recipe,
                  audit=audit, audit_every=int(audit_every), rank=rank,
                  source="repro_torch.launch.train")
        emit_plan_telemetry(sink, tracer, optim, cfg, plans, dpm.sizes,
                            n_buckets, block_size, cluster, device_spec,
                            dev, drift_probe=drift_probe,
                            telemetry_dir=telemetry, overlap_bwd=overlap_on,
                            batch=batch, seq=seq, tp=tp)
    memory_on = memory == "on" and sink.enabled
    mem_ledger = mem_sampler = None
    mem_programs = {}        # step program -> CompiledMemory
    if memory_on:
        from repro_torch.obs.mem import LiveSampler
        mem_ledger = build_memory_ledger(
            optim, cfg, comp_plan, dpm.sizes, topology, n_buckets,
            block_size, cluster, device_spec, layout, batch, seq,
            overlap_bwd=overlap_on, tp=tp)
        sink.emit("memory", **mem_ledger.event_fields())
        mem_sampler = LiveSampler(dev)

    def on_warning(wstep: int, detail: str) -> None:
        print(f"[warn] step {wstep}: {detail}", flush=True)
        sink.emit("warning", what="non-finite v_l1", step=wstep,
                  detail=detail)

    def on_bad_stat(wstep: int, key: str, value: float) -> None:
        print(f"[warn] step {wstep}: non-finite {key} ({value}) dropped "
              f"from the step event", flush=True)
        sink.emit("warning", what=f"non-finite {key}", step=wstep,
                  detail=f"{key}={value} rejected by FiniteGuard")

    # --- the per-segment fidelity audit (repro_torch.obs.audit) ----------
    audit_on = audit == "on"
    guard = FiniteGuard()
    health = HealthMonitor()
    abuf = MetricBuffer() if audit_on else None
    audit_probe = shadow_v = None     # built at the first audited step
    audit_idx = 0                     # compression-stage steps seen

    def emit_audit(s: int, fid: dict) -> None:
        def finite(xs):
            return [x for x in xs if math.isfinite(x)] \
                if isinstance(xs, list) else []
        drift, cos, sign = (finite(fid.get(k)) for k in
                            ("v_drift", "cos_sim", "sign_agree"))
        extra = {}
        if drift:
            extra["v_drift_max"] = max(drift)
            extra["v_drift_min"] = min(drift)
        if cos:
            extra["cos_sim_min"] = min(cos)
        if sign:
            extra["sign_agree_min"] = min(sign)
        n_seg = fid.get("cos_sim")
        n_seg = len(n_seg) if isinstance(n_seg, list) else 1
        sink.emit("fidelity", step=s, n_segments=n_seg, stage="compressed",
                  source="repro_torch.launch.train", **fid, **extra)
        hfields, warns = health.observe(s, fid)
        sink.emit("health", **hfields)
        for w in warns:
            print(f"[health] step {s}: {w['what']} — {w['detail']}",
                  flush=True)
            sink.emit("warning", **w)

    mbuf = MetricBuffer()
    pending = {}      # step -> the record's fields known at launch
    history = []

    def drain() -> None:
        """Every parked step's metrics in one copy, folded into the
        history and the step events in step order; then the audited
        steps' stats into fidelity and health events."""
        for s, m in mbuf.drain():
            rec = dict(pending.pop(s), **m)
            history.append(rec)
            ev = guard.filter(s, rec, on_reject=on_bad_stat)
            sink.emit("step", optimizer=optim.name, **ev)
            health.observe_loss(s, m.get("loss"))
        if abuf is not None:
            for s, fid in abuf.drain():
                emit_audit(s, fid)

    was_compressed = switch.compressed(start_step - 1) if start_step else \
        False
    prev_sync = True
    prof_start = max(start_step, steps - max(profile_steps, 1)) \
        if profile else None
    prof = prof_span = None
    trace_path = None
    profile_fields = None
    win_t0, win_step0 = time.time(), start_step
    def log_window(step: int, stage: str, sync: bool, over: bool,
                   t0: float) -> None:
        """A log boundary: the window's metrics in one copy, the
        ``train.window`` span, the printed line, the step events, and a
        live memory sample."""
        nonlocal win_t0, win_step0
        host = mbuf.host(step)                 # waits for the step
        if log_every == 1:
            pending[step]["ms"] = (time.perf_counter() - t0) * 1e3
        now = time.time()
        sink.emit("span", name="train.window", stream="host",
                  t_start=win_t0, dur=now - win_t0,
                  n=step - win_step0 + 1, step=step)
        if verbose and rank == 0:
            tail = (f"{pending[step]['ms']:.1f} ms" if log_every == 1
                    else f"window {now - win_t0:.2f} s, "
                    f"{step - win_step0 + 1} steps")
            print(f"step {step:5d} [{stage:10s}"
                  f"{'' if sync else ' local'}"
                  f"{' overlap' if over else ''}] "
                  f"loss {host['loss']:.4f} acc {host['acc']:.3f} "
                  f"v_l1 {host['v_l1']:.3e} ({tail})", flush=True)
        win_t0, win_step0 = now, step + 1
        drain()
        if mem_sampler is not None:
            mfields = mem_sampler.sample(step)
            if mfields:
                sink.emit("memory", **mfields)
                hfields, warns = health.observe_memory(
                    step, mfields["bytes_in_use"],
                    mfields.get("peak_bytes_in_use"),
                    capacity_bytes=mem_ledger.capacity_bytes)
                sink.emit("health", **hfields)
                for w in warns:
                    print(f"[health] step {step}: {w['what']} — "
                          f"{w['detail']}", flush=True)
                    sink.emit("warning", **w)

    build.reset_launch_counts()
    try:
        for step in range(start_step, steps):
            if step == prof_start:
                # the traced window holds exactly the profiled steps: wait
                # for the work in flight, then open the profiler and the
                # host range the fold takes as its wall clock
                from torch.profiler import ProfilerActivity
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                os.makedirs(profile, exist_ok=True)
                acts = [ProfilerActivity.CPU]
                if dev.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
                prof_span = tracer.span("profile.window",
                                        n=steps - prof_start, step=step)
                prof_span.__enter__()
            if stage_override:
                stage, sync = stage_override, True
            else:
                compressed = switch.compressed(step)
                if compressed and not was_compressed:
                    ratio = switch.ratio if switch.mode == "auto" else None
                    sink.emit("transition", step=step, kind="stage",
                              frm="warmup", to="compressed",
                              mode=switch.mode,
                              **({"ratio": float(ratio)}
                                 if ratio is not None else {}))
                    was_compressed = True
                stage = "compressed" if compressed else "warmup"
                sync = optim.sync_due(comp_step) if compressed else True
                comp_step += compressed
            if sync != prev_sync:
                sink.emit("transition", step=step, kind="sync",
                          frm="sync" if prev_sync else "local",
                          to="sync" if sync else "local")
                prev_sync = sync
            batch_t = stream.batch_at(step)
            over = overlap_applies(stage, sync, n_buckets, overlap)
            if audit_on and stage == "compressed":
                if audit_idx % max(audit_every, 1) == 0:
                    if audit_probe is None:
                        audit_probe = make_audit_probe(
                            ts, optim, *exchange_axes(topology, dp_axes,
                                                      pod_axes),
                            tp_axes=tp_axes)
                        shadow_v = ts.opt.v.clone()   # seed the shadow EMA
                    # before the step: the (params, state, batch) it takes
                    shadow_v, astats = audit_probe(batch_t, shadow_v)
                    abuf.push(step, astats)
                audit_idx += 1
            program = stage if sync else f"{stage}_local"
            if memory_on and program not in mem_programs:
                from repro_torch.obs.mem import StepMemory
                reader = StepMemory(program, dev)
            else:
                reader = contextlib.nullcontext()
            t0 = time.perf_counter()
            with reader:
                metrics = train_step(ts, optim, batch_t,
                                     lr_schedule(step, lr, lr_warmup),
                                     stage, dp_axes, sync=sync,
                                     pod_axes=pod_axes, topology=topology,
                                     n_buckets=n_buckets,
                                     overlap_bwd=overlap, tp_axes=tp_axes)
            if getattr(reader, "memory", None) is not None:
                mem_programs[program] = reader.memory
            mbuf.push(step, {k: metrics[k] for k in sorted(metrics)})
            pending[step] = {"step": step, "stage": stage, "sync": sync,
                             "overlap": over,
                             "stage0_in_bwd": ts.stage0_in_bwd}
            boundary = step % log_every == 0 or step == steps - 1
            if switch.mode == "auto" and not stage_override:
                # the variance-ratio rule needs v_l1 every step: one
                # batched copy of the step's metrics
                switch.observe(step, mbuf.host(step), on_warning=on_warning)
            elif not stage_override:
                switch.observe(step, {})
            if boundary:
                log_window(step, stage, sync, over, t0)
            if ckpt and (step + 1) % CKPT_EVERY == 0 and step + 1 < steps:
                with tracer.span("checkpoint.save", step=step):
                    save(step + 1)
        drain()
        if prof is not None:
            # the last step's metrics were fetched (a host sync): the
            # window's wall clock is honest
            prof_span.__exit__(None, None, None)
            prof_span = None
            prof.stop()
            trace_path = os.path.join(profile, f"trace_rank{rank}.json")
            prof.export_chrome_trace(trace_path)
            prof = None
        mem_extra = None
        if memory_on:
            from repro_torch.obs.mem import mem_metrics
            biggest = emit_memory_attribution(mem_programs, sink,
                                              mem_ledger, telemetry)
            mem_extra = mem_metrics(mem_ledger, compiled=biggest,
                                    live_peak=mem_sampler.peak_bytes)
        if trace_path is not None:
            try:
                profile_fields = emit_profile_ledger(
                    trace_path, profile, sink, optim, cfg, plans,
                    dpm.sizes, n_buckets, block_size, cluster, device_spec,
                    dev.type, n_steps=steps - prof_start, stage=stage,
                    bench=bench, arch=arch, rank=rank,
                    extra_metrics=mem_extra, overlap_bwd=overlap_on,
                    batch=batch, seq=seq, tp=tp)
            except ValueError as e:   # a failed fold must not lose the run
                sink.emit("warning", what="profile.fold",
                          detail=str(e)[:400])
                print(f"[warn] profile fold failed: {e}", flush=True)
        if ckpt:
            with tracer.span("checkpoint.save", step=steps):
                save(steps)
    finally:
        if prof_span is not None:      # abnormal exit mid-window
            prof_span.__exit__(None, None, None)
        if prof is not None:
            prof.stop()
        set_tracing(False)
        sink.close()
    if sink.enabled and verbose:
        print(f"telemetry: {sink.n_events} events -> {sink.path}",
              flush=True)
    if audit_on and health.n_checked and verbose:
        print(f"audit: {health.n_checked} health check(s), "
              f"{health.n_failed} failed"
              + (f"; {guard.n_rejected} non-finite stat(s) dropped"
                 if guard.n_rejected else ""), flush=True)
    if log_file:
        with open(log_file, "w") as f:
            json.dump(history, f)
    return {"history": history, "launches": build.launch_counts(),
            "d": ts.d, "d_pad": d_pad, "state": ts, "optimizer": optim,
            "layout": layout, "start_step": start_step,
            "checkpoint_s": io_s, "topology": topology,
            "n_buckets": n_buckets, "overlap_bwd": overlap,
            "plan": plan_name,
            "schedule": tuned.best if tuned else None, "tp": tp,
            "telemetry": sink.path, "profile": profile_fields}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="bert-base-smoke",
                    help="a registered arch (repro_torch.configs."
                         "list_archs()), or one with -smoke for its "
                         "reduced config")
    ap.add_argument("--recipe", default="onebit_adam",
                    choices=list_optim_recipes())
    ap.add_argument("--optimizer", default=None,
                    help="override the recipe's optimizer (registry name)")
    ap.add_argument("--compressor", default=None,
                    help="override the recipe's compressor (registry name)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--warmup-steps", type=int, default=None,
                    help="manual T_w (compressed from this step on)")
    ap.add_argument("--auto-warmup", action="store_true",
                    help="the variance-ratio rule picks T_w, even with "
                         "--warmup-steps")
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch, split over the dp ranks")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lr-warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt", default=None,
                    help="save parameters and optimizer state here (npz)")
    ap.add_argument("--resume", default=None,
                    help="continue from this checkpoint at its step")
    ap.add_argument("--stage", default=None,
                    choices=[None, "warmup", "compressed"],
                    help="force every step's stage")
    ap.add_argument("--mesh", default=None,
                    help="N, NxT or PxNxT (pods x data x model); "
                         "default: one dp axis over WORLD_SIZE ranks")
    ap.add_argument("--topology", default=None,
                    choices=[None, "flat", "hier", "auto"],
                    help="hier = the two-level exchange (flat on one pod); "
                         "auto = the plan tuner picks per --cluster; "
                         "default: the recipe's")
    ap.add_argument("--pipeline", default=None,
                    help="off, a bucket count N (the pipelined exchange) "
                         "or auto; default: the recipe's")
    ap.add_argument("--overlap-bwd", default="off",
                    choices=["off", "on", "auto"],
                    help="issue each bucket's exchange from inside "
                         "backward (needs --pipeline > 1); auto = the "
                         "four-stream cost model decides")
    ap.add_argument("--cluster", default="ethernet-10g",
                    help="link preset the auto values are priced on "
                         "(repro_torch.plan.list_clusters()), or "
                         "measured:<comm_sweep.json>")
    ap.add_argument("--device-spec", default=None,
                    help="device preset of the compute pricing "
                         "(repro_torch.perf.list_devices()) or "
                         "measured:<kernel_sweep.json>; default h100-sxm "
                         "on cuda, cpu-host on cpu")
    ap.add_argument("--telemetry", default=None, metavar="DIR",
                    help="write structured run telemetry to "
                         "DIR/telemetry.jsonl (typed step/transition/plan/"
                         "span events, the executors' obs:: trace ranges); "
                         "summarize with python -m repro_torch.obs.report")
    ap.add_argument("--log-every", type=int, default=10,
                    help="print and drain the buffered metrics every N "
                         "steps (one device-to-host copy a window)")
    ap.add_argument("--log-file", default=None,
                    help="write the per-step history here as JSON")
    ap.add_argument("--audit", default="off", choices=["off", "on"],
                    help="the per-segment compression-fidelity and "
                         "frozen-variance audit: a probe on its own "
                         "gradient buffer every --audit-every compression-"
                         "stage steps emits fidelity and health events; "
                         "training is bitwise unchanged")
    ap.add_argument("--audit-every", type=int, default=10,
                    help="audit every N-th compression-stage step")
    ap.add_argument("--memory", default="off", choices=["off", "on"],
                    help="with --telemetry: the predicted per-rank memory "
                         "ledger, a live sample every log window with the "
                         "mem_headroom/mem_growth verdicts, and the "
                         "allocator's peak around the first step of each "
                         "step program attributed onto the ledger")
    ap.add_argument("--drift-probe", action="store_true",
                    help="with --telemetry: time each compressed-exchange "
                         "collective on the real process groups before "
                         "training and run the cost-model drift monitor "
                         "(writes recalibration.json on drift)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace the last --profile-steps steps with "
                         "torch.profiler into DIR/trace_rank<r>.json, fold "
                         "it onto the plan grid (a profile event) and "
                         "write DIR/BENCH_<--bench>.json")
    ap.add_argument("--profile-steps", type=int, default=4,
                    help="steady-state steps the --profile trace covers")
    ap.add_argument("--bench", default=None, metavar="NAME",
                    help="ledger name for --profile (BENCH_<NAME>.json; "
                         "default: train)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world > 1:   # under torchrun: it provides MASTER_ADDR/PORT and RANK
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    try:
        run(arch=args.arch, recipe=args.recipe, steps=args.steps,
            warmup_steps=args.warmup_steps, batch=args.batch, seq=args.seq,
            block_size=args.block_size, lr=args.lr,
            lr_warmup=args.lr_warmup, seed=args.seed, device=args.device,
            optimizer=args.optimizer, compressor=args.compressor,
            ckpt=args.ckpt, resume=args.resume, stage_override=args.stage,
            mesh=args.mesh, topology=args.topology, pipeline=args.pipeline,
            overlap_bwd=args.overlap_bwd, cluster=args.cluster,
            device_spec=args.device_spec, telemetry=args.telemetry,
            log_every=args.log_every, log_file=args.log_file,
            profile=args.profile, profile_steps=args.profile_steps,
            memory=args.memory, audit=args.audit,
            audit_every=args.audit_every, drift_probe=args.drift_probe,
            bench=args.bench, auto_warmup=args.auto_warmup)
    finally:
        if world > 1:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
