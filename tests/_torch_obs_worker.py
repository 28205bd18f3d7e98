"""Spawned gloo ranks for the observability tests (tests/test_torch_obs.py
and test_torch_obs_profile.py).  They import torch and the port only.

``spans_main``: on a 2 x 2 (pod x data) mesh, the flat plan over all four
ranks, the hierarchical plan and the flat plan over 2 buckets, each run
once with tracing off and once with tracing on under ``torch.profiler``;
saves per plan the ``obs::`` range names of the trace, the
``torch.distributed`` calls of both runs (``ByteCounter.calls``) and
whether both runs' results and EF slots are bitwise equal; then
``probe_plan`` of the hierarchical plan (intra and cross samples).  Writes
``spans<rank>.json``.

``runs_main``: the port's ``run`` per entry of ``runs.json`` under the
call counter; saves each run's history (without the step walls), its
calls, a digest of its parameters and state, and its telemetry log's
path to ``runs<rank>.json``.
"""
import hashlib
import json
import os

import torch
import torch.distributed as dist

D = 1024
BLOCK = 64


def _init(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)          # the ranks share the host's cores
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "rendezvous"),
        rank=rank, world_size=world)


def _trace_names(path: str):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted({e["name"] for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("obs::")})


def spans_main(rank: int, world: int, workdir: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.benchmarks.comm_volume import ByteCounter
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.obs.drift import probe_plan
    from repro_torch.obs.trace import tracing
    from repro_torch.optim import get_compressor
    from repro_torch.pipeline import (Bucketer, execute_pipelined,
                                      lower_to_pipelined)
    from repro_torch.plan import execute_plan, flat_schedule, hier_schedule
    _init(rank, world, workdir)
    try:
        build_mesh("2x2x1", "cpu")
        comp = get_compressor("onebit", block_size=BLOCK)
        flat = flat_schedule(comp, D, 4, ("pod", "data"))
        plans = {
            "flat": flat,
            "hier": hier_schedule(comp, D, 2, 2, ("data",), ("pod",),
                                  outer_ef=False),
            "pipe2": lower_to_pipelined(
                flat, comp, Bucketer.for_exchange(D, 4, BLOCK, 2)),
        }
        x = torch.randn(D, generator=torch.Generator().manual_seed(rank))
        out = {}
        for key, plan in plans.items():
            serial = flat if key == "pipe2" else plan
            errs = {op.err_slot: torch.zeros(op.d_in) for op in serial.ops
                    if op.err_slot is not None}
            run = execute_pipelined if key == "pipe2" else execute_plan
            with ByteCounter() as off:
                v_off, e_off = run(plan, comp, x, dict(errs))
            trace = os.path.join(workdir, f"trace_{key}_{rank}.json")
            with tracing(True), ByteCounter() as on, \
                    profile(activities=[ProfilerActivity.CPU]) as prof:
                v_on, e_on = run(plan, comp, x, dict(errs))
            prof.export_chrome_trace(trace)
            out[key] = {
                "names": _trace_names(trace),
                "calls_off": off.calls, "calls_on": on.calls,
                "bitwise": torch.equal(v_off, v_on) and all(
                    torch.equal(e_off[k], e_on[k]) for k in e_off)}
        out["probe"] = [s.__dict__ for s in probe_plan(plans["hier"], "cpu",
                                                       iters=2, repeats=3)]
        with open(os.path.join(workdir, f"spans{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()


def runs_main(rank: int, world: int, workdir: str) -> None:
    from repro_torch.benchmarks.comm_volume import ByteCounter
    from repro_torch.launch.train import run
    _init(rank, world, workdir)
    try:
        with open(os.path.join(workdir, "runs.json")) as f:
            specs = json.load(f)
        out = {}
        for name, kw in specs.items():
            with ByteCounter() as calls:
                res = run(device="cpu", verbose=False, **kw)
            ts = res["state"]
            out[name] = {
                "history": [{k: v for k, v in h.items() if k != "ms"}
                            for h in res["history"]],
                "calls": calls.calls,
                "state": {"x": _digest(ts.x),
                          **{k: _digest(v) for k, v in ts.opt.items()}},
                "telemetry": res["telemetry"],
                "profile": res["profile"] is not None}
        with open(os.path.join(workdir, f"runs{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
