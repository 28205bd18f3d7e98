"""Multi-pod dry run: trace every (architecture x input shape x mesh)
combination as rank 0 of the production mesh and report its roofline
terms and memory, with no card and no data.

The port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each step against 512 placeholder devices and reads the compiled
artifact; here one process stands in for rank 0 of the mesh:

  * ``torch.distributed`` runs torch's fake process group at the mesh's
    world size (:func:`fake_world`: every collective returns at once and
    moves nothing), and ``launch.mesh.build_mesh`` builds its groups;
  * the params (``leaf_shapes(cfg, tp)``: this model rank's shards), the
    flat ``TrainState``, the batch and the decode caches are empty
    tensors on the meta device, so nothing is allocated or computed;
  * one ``train_step``, prefill or decode runs under
    ``analysis.roofline.StepCounter`` (dot FLOPs and bytes, collective
    bytes by kind, the hand-written kernels' launches priced by
    ``perf.kernel_cost``), and its peak live bytes come from
    ``torch.distributed._tools.mem_tracker.MemTracker``.

The report has the reference's keys; ``trace_s`` takes the place of
``lower_s`` / ``compile_s`` (nothing compiles), ``fits_hbm`` holds the
traced peak against ``h100-sxm``'s 80 GB, and a training shape adds the
``obs.mem.predict_ledger`` rows beside the traced peak.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape decode_32k [--multi-pod] [--stage warmup|compressed|
      compressed_hier|compressed_zero1] [--sp] [--mesh 4x4] [--json out]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
from typing import Dict, Iterator, Mapping, Optional, Union

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import SHAPES, ArchConfig, InputShape
from repro_torch.perf.device import DEVICES

HBM_BYTES = DEVICES["h100-sxm"].hbm_bytes

ASSIGNED = [
    "llama3.2-3b", "deepseek-7b", "granite-34b", "falcon-mamba-7b",
    "jamba-1.5-large-398b", "internlm2-1.8b", "musicgen-large",
    "llama4-scout-17b-a16e", "internvl2-2b", "mixtral-8x22b",
]
STAGES = ("warmup", "compressed", "compressed_hier", "compressed_zero1")
BLOCK = 4096


def skip_reason(arch: str, shape_name: str) -> Optional[str]:
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.supports_long_decode:
        return ("full-attention KV over 524288 tokens is not sub-quadratic-"
                "memory; skipped per DESIGN.md (run SSM/hybrid/SWA archs)")
    if shape_name in ("decode_32k", "long_500k") and cfg.family == "encoder":
        return "encoder-only model has no decode step"
    return None


@contextlib.contextmanager
def fake_world(world: int) -> Iterator[None]:
    """This process as rank 0 of ``world`` ranks of torch's fake process
    group while the block runs; on exit the group and the executor's axes
    map are torn down."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.plan import executor as _exec
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    prev = _exec.set_groups({})
    try:
        yield
    finally:
        dist.destroy_process_group()
        _exec.set_groups(prev)


def input_batch(cfg: ArchConfig, shape: InputShape, batch: int,
                device="meta") -> Dict[str, torch.Tensor]:
    """Empty model inputs of ``batch`` sequences of ``shape``, as the
    reference's ``input_specs``: train / prefill full sequences (the VLM's
    text after its patch prefix; the audio stub's frames), a decode one
    new token a sequence; labels for training only."""
    s, emb = shape.seq_len, getattr(torch, cfg.compute_dtype)

    def empty(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device=device)
    if shape.kind == "decode":
        if cfg.embed_kind == "embeddings":
            return {"embeddings": empty((batch, 1, cfg.d_model), emb)}
        return {"tokens": empty((batch, 1))}
    if cfg.embed_kind == "embeddings":
        out = {"embeddings": empty((batch, s, cfg.d_model), emb),
               "labels": empty((batch, s))}
    elif cfg.embed_kind == "prefix":
        st = s - cfg.n_prefix
        out = {"tokens": empty((batch, st)),
               "patch_embeds": empty((batch, cfg.n_prefix, cfg.d_model), emb),
               "labels": empty((batch, st))}
    else:
        out = {"tokens": empty((batch, s)), "labels": empty((batch, s))}
        if cfg.family == "encoder":
            out["loss_mask"] = empty((batch, s), torch.float32)
    if shape.kind == "prefill":
        out.pop("labels")
        out.pop("loss_mask", None)
    return out


def _meta_params(cfg: ArchConfig, tp: int) -> Dict[str, torch.Tensor]:
    from repro_torch.models.transformer import leaf_shapes
    return {p: torch.empty(s, device="meta")
            for p, s in leaf_shapes(cfg, tp)}


def _live_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors``."""
    return sum({id(t.untyped_storage()): t.untyped_storage().nbytes()
                for t in tensors}.values())


def _state_tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, Mapping):
        for v in obj.values():
            yield from _state_tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _state_tensors(v)


def _traced(fn, held) -> tuple:
    """Run ``fn`` under the roofline counter and the memory tracker, with
    ``held`` (the tensors live before the step: params, state, inputs,
    caches) tracked as external; (counter, peak bytes, held bytes)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.analysis.roofline import StepCounter
    held = list(held)
    mt = MemTracker()
    mt.track_external(*held)
    with StepCounter() as counter, mt:
        fn()
    peak = mt.get_tracker_snapshot("peak")
    peak_bytes = max((v["Total"] for v in peak.values()), default=0)
    return counter, int(peak_bytes), _live_bytes(held)


def _train(cfg, shape, mesh, stage, seq_parallel, accum_steps):
    """(step thunk, the tensors it holds, topology, layout): one
    ``train_step`` of ``stage`` on rank 0's shard of ``shape``."""
    from repro_torch.launch.mesh import pod_split
    from repro_torch.optim import get_optimizer
    from repro_torch.train.step import init_train_state, train_step
    n_dp, tp = mesh.n_dp, mesh.tp
    dp_axes, pod_axes, n_inner, n_outer = pod_split(mesh.axes, mesh.sizes) \
        if n_dp > 1 else ((), (), 1, 1)
    hier = stage == "compressed_hier" and n_outer > 1
    layout = "zero1" if stage == "compressed_zero1" else "replicated"
    optim = get_optimizer("onebit_adam", compressor="onebit",
                          compressor_kwargs={"block_size": BLOCK})
    ts = init_train_state(cfg, _meta_params(cfg, tp), optim, BLOCK, n_dp,
                          "meta", layout=layout,
                          n_inner=n_inner if hier else None,
                          ctx=mesh.parallel_ctx(),
                          seq_parallel=seq_parallel)
    if shape.global_batch % n_dp:
        raise ValueError(f"a batch of {shape.global_batch} does not split "
                         f"over {n_dp} dp ranks")
    batch = input_batch(cfg, shape, shape.global_batch // n_dp)
    step_stage = "warmup" if stage == "warmup" else "compressed"

    def step():
        train_step(ts, optim, batch, 1e-4, step_stage, dp_axes,
                   accum_steps=accum_steps, pod_axes=pod_axes,
                   topology="hier" if hier else "flat",
                   tp_axes=mesh.tp_axes)
    held = [ts.x, ts.g, *_state_tensors(ts.opt), *batch.values()]
    return step, held, ("hier" if hier else "flat"), layout


def _serve(cfg, shape, mesh):
    """(step thunk, the tensors it holds): one prefill or decode of
    ``shape`` through ``train.step.make_serve_step``."""
    from repro_torch.train.step import make_serve_step
    params = _meta_params(cfg, mesh.tp)
    step = make_serve_step(cfg, mesh, shape, device="meta")
    batch = input_batch(cfg, shape, shape.global_batch)
    held = list(params.values()) + list(batch.values())
    if shape.kind == "prefill":
        return (lambda: step(params, batch)), held
    caches = step.init_caches(dtype=torch.bfloat16)
    held += list(_state_tensors(caches))
    pos = shape.seq_len - 1
    return (lambda: step(params, batch, caches, pos)), held


def lower_one(arch: str, shape_name: Union[str, InputShape],
              multi_pod: bool = False, stage: str = "compressed",
              seq_parallel: bool = False, mesh_override=None,
              cfg_overrides: Dict = None, accum_steps: int = 1) -> Dict:
    """Trace one combination as rank 0 of its mesh; returns the report.

    ``shape_name``: a key of ``SHAPES`` or an ``InputShape``.
    ``mesh_override``: a mesh written ``NxT`` / ``PxNxT`` or its dims
    (default: the production mesh, 16 x 16, or 2 x 16 x 16 with
    ``multi_pod``).  ``cfg_overrides``: ``ArchConfig`` field overrides."""
    from repro_torch.analysis.roofline import H100
    from repro_torch.launch.mesh import (MULTI_POD_MESH, PRODUCTION_MESH,
                                         build_mesh, parse_mesh)
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; one of {STAGES}")
    if mesh_override is None:
        mesh_override = MULTI_POD_MESH if multi_pod else PRODUCTION_MESH
    dp_sizes, tp = parse_mesh(mesh_override)
    spec = "x".join(str(s) for s in dp_sizes + (tp,))
    t0 = time.time()
    with fake_world(math.prod(dp_sizes) * tp):
        mesh = build_mesh(spec)
        topology, layout = "flat", "replicated"
        if shape.kind == "train":
            fn, held, topology, layout = _train(cfg, shape, mesh, stage,
                                                seq_parallel, accum_steps)
        else:
            fn, held = _serve(cfg, shape, mesh)
        counter, peak, arg = _traced(fn, held)
    rep = counter.report(H100, arg_bytes=arg, peak_bytes=peak)
    out = {
        "arch": arch, "shape": shape.name, "mesh": spec,
        "stage": stage if shape.kind == "train" else shape.kind,
        "seq_parallel": bool(seq_parallel),
        "cfg_overrides": cfg_overrides or {},
        "n_chips": math.prod(dp_sizes) * tp,
        "trace_s": round(time.time() - t0, 1),
        "roofline": rep.summary(),
        "memory": {"peak_bytes": peak, "arg_bytes": arg,
                   "temp_bytes": rep.temp_bytes},
        "fits_hbm": bool(peak <= HBM_BYTES),
    }
    if shape.kind == "train":
        from repro_torch.obs.mem import predict_ledger
        ledger = predict_ledger(
            cfg, dp_sizes, layout=layout, topology=topology, block=BLOCK,
            batch_global=shape.global_batch, seq=shape.seq_len,
            capacity_bytes=float(HBM_BYTES), tp=tp)
        out["memory_ledger"] = {"predicted": ledger.summary(),
                                "traced_peak_bytes": peak}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list_archs() + ["all"], default="all")
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"], default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--stage", default="compressed", choices=list(STAGES))
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel residual stream (train shapes)")
    ap.add_argument("--mesh", default=None,
                    help="override mesh, e.g. 64x4 (dp x model)")
    ap.add_argument("--json", default=None, help="append results to file")
    args = ap.parse_args(argv)
    archs = ASSIGNED if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    mesh_name = args.mesh or ("2x16x16" if args.multi_pod else "16x16")
    results, failures = [], []
    for arch in archs:
        for shape in shapes:
            reason = skip_reason(arch, shape)
            tag = f"{arch} x {shape} x {mesh_name}"
            if reason:
                print(f"SKIP {tag}: {reason}")
                results.append({"arch": arch, "shape": shape,
                                "skipped": reason})
                continue
            try:
                r = lower_one(arch, shape, args.multi_pod, args.stage,
                              seq_parallel=args.sp,
                              mesh_override=args.mesh)
                rl = r["roofline"]
                print(f"OK   {tag}: trace {r['trace_s']}s "
                      f"bottleneck={rl['bottleneck']} "
                      f"t=(c {rl['t_compute_s']:.3e}, m {rl['t_memory_s']:.3e},"
                      f" x {rl['t_collective_s']:.3e}) "
                      f"peak={r['memory']['peak_bytes'] / 1e9:.2f} GB "
                      f"fits_hbm={r['fits_hbm']}", flush=True)
                results.append(r)
            except Exception as e:  # a failure here is a bug in the system
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                failures.append((tag, str(e)))
    if args.json:
        with open(args.json, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    if failures:
        print(f"\n{len(failures)} FAILURES")
        sys.exit(1)
    print(f"\nall {len(results)} combinations OK")


if __name__ == "__main__":
    main()
