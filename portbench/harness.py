"""The benchmark's run of one cell: set-up, the measured window, the traced
steps, and the comparison with the reference.

A cell is a ``workloads`` entry of ``BENCHMARK.json``: a configuration
(``configs/<name>.json``, its reference ``reference/<name>.py`` and FLOP
count ``flops/<name>.py``), a traffic mix (``traffic/<name>.json``) and
the comparison's limits (``limits/<cell>.json``).  Each metric is read by
``metrics/<metric>.py``.  Nothing here names a cell, a configuration or
a metric: a later change adds one by adding files.

One rank a card.  On more than one card the ranks are spawned processes
that meet through a ``file://`` rendezvous under the run's temporary
directory; rank 0 hands its record to the process that prints.

Each rank, in order:

1. set-up: the program's mesh, the weights from the seed on the device,
   the training state (``init_train_state``) and optimizer, the batch
   pool, and ``setup_steps`` steps through the window's own step, which
   also give the program's side of the comparison (its loss, its state
   after one step, its parameters after three);
2. the window: steps until ``--seconds`` have passed, between two device
   syncs, after ``reset_peak_memory_stats``;
3. with ``--trace 1``, ``traced_steps`` more steps under the profiler,
   each in a ``portbench.step`` range, with the program's spans on, the
   launch spies the readers declare and a count of the bytes handed to
   ``torch.distributed`` on each group;
4. the program's state freed, the reference follows the first three
   steps (every warmup step, where the traffic has a compression stage,
   and the first two compressed steps from the program's state at the
   switch), and rank 0 compares.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the port's ArchConfig fields a configuration file sets
PORT_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
               "vocab", "causal", "mlp_kind", "rope_theta", "norm_eps",
               "compute_dtype", "remat_policy")
# the control's state: one precision step below the configured float32
CONTROL_DTYPE = "bfloat16"
# the calls the wire counter spies on, with the tensor argument each sends;
# the program gathers through all_gather_single where torch has it (2.13)
# and all_gather_into_tensor where it does not (2.11)
DIST_CALLS = {"all_reduce": 0, "broadcast": 0, "all_to_all_single": 1,
              "all_gather_into_tensor": 1, "all_gather_single": 1,
              "reduce_scatter_tensor": 1}


# --------------------------------------------------------------------------
# the cell
# --------------------------------------------------------------------------

def load_cell(name: str, root: Path = ROOT) -> dict:
    man = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    lim_path = root / "portbench" / "limits" / f"{name}.json"

    def mine(metrics):
        return [m for m in metrics
                if "workloads" not in m or name in m["workloads"]]
    return {"name": name, "chips": int(w["chips"]),
            "config": json.loads((root / conf["file"]).read_text()),
            "traffic": json.loads((root / "portbench" / "traffic"
                                   / f"{w['traffic']}.json").read_text()),
            "limits": json.loads(lim_path.read_text())
            if lim_path.exists() else {},
            "end_to_end": mine(man["end_to_end"]),
            "per_layer": mine(man["per_layer"])}


def _module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    key = f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def reference_of(cfg: dict):
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def port_config(cfg: dict):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(cfg["arch"]),
                               **{k: cfg[k] for k in PORT_FIELDS})


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# --------------------------------------------------------------------------
# faults planted under the program's step (the calibration and the tests)
# --------------------------------------------------------------------------

def _unchanged(train_step, ts, optim, batch, lr, stage, *a, **k):
    """A step that computes its loss and returns the state unchanged."""
    import torch
    from repro_torch.models.transformer import loss_fn
    with torch.no_grad():
        total, met = loss_fn(ts.model, batch)
    return dict(met, total=total)


def _half_batch(train_step, ts, optim, batch, *a, **k):
    """Half of the batch left out: the mean over the rest."""
    n = next(iter(batch.values())).shape[0] // 2
    return train_step(ts, optim, {key: v[:n] for key, v in batch.items()},
                      *a, **k)


def _local_exchange(x, errs, dp_axes, pod_axes, comp, n_buckets=1):
    """The compressed exchange with the peers left out: the worker's and
    the server's compression of this rank's own momentum alone."""
    from repro_torch.core import comm
    n, r = comm.axis_size(dp_axes), comm.axis_index(dp_axes)
    payload, werr = comp.ef_compress(x, errs["worker"])
    out = comp.decompress(payload)
    chunk = x.shape[0] // n
    mine = out[r * chunk:(r + 1) * chunk]
    payload, serr = comp.ef_compress(mine.contiguous(), errs["server"])
    out[r * chunk:(r + 1) * chunk] = comp.decompress(payload)
    return out, dict(errs, worker=werr, server=serr)


def _no_exchange(train_step, *a, **k):
    """The exchange between the dp ranks left out: no warmup mean, and
    the compressed exchange of this rank's momentum alone."""
    from repro_torch.core import comm
    saved = comm.allreduce_mean, comm.compressed_exchange
    comm.allreduce_mean = lambda x, axes: x
    comm.compressed_exchange = _local_exchange
    try:
        return train_step(*a, **k)
    finally:
        comm.allreduce_mean, comm.compressed_exchange = saved


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange}


def step_function(fault: Optional[str]) -> Callable:
    from repro_torch.train import step as S
    if fault is None:
        return S.train_step
    return functools.partial(FAULTS[fault], S.train_step)


# --------------------------------------------------------------------------
# one rank
# --------------------------------------------------------------------------

class Rank:
    """One rank's process-wide context: device, mesh, configurations."""

    def __init__(self, rank: int, world: int, job: dict):
        import torch
        import torch.distributed as dist
        from repro_torch.launch.mesh import build_mesh
        self.rank, self.world, self.job = rank, world, job
        cell = job["cell"]
        self.cfg, self.traffic = cell["config"], cell["traffic"]
        self.ref = reference_of(self.cfg)
        self.pcfg = port_config(self.cfg)
        if job["device"] == "cuda":
            self.dev = torch.device("cuda", rank)
            torch.cuda.set_device(self.dev)
            os.environ["LOCAL_RANK"] = str(rank)
        else:
            self.dev = torch.device("cpu")
        self.stop_group = None
        self.ref_seconds: List[float] = []
        if world > 1:
            dist.init_process_group(
                "nccl" if self.dev.type == "cuda" else "gloo",
                init_method="file://" + job["rendezvous"], rank=rank,
                world_size=world)
            self.stop_group = dist.new_group(backend="gloo")
        self.mesh = build_mesh(self.traffic["mesh"])
        self.tp, self.n_dp = self.mesh.tp, self.mesh.n_dp
        self.mr, self.dp_rank = self.mesh.model_rank, self.mesh.dp_rank
        self.dp_axes = tuple(self.mesh.axes) if self.n_dp > 1 else ()
        self.dp_group = self.mesh.groups.get(tuple(self.mesh.axes)) \
            if self.n_dp > 1 else None
        self.block = self.cfg["block_size"]
        from repro_torch.train.step import flat_dim
        self.d_pad = flat_dim(self.pcfg, self.n_dp, self.block, self.tp)
        leaves = self.ref.leaves(self.cfg, self.tp)
        self.sizes = self.ref.shard_sizes(self.cfg, self.tp)
        self.splits = [lf.split is not None for lf in leaves]
        from repro_torch.models.transformer import leaf_shapes
        mine = [(lf.path, self.ref.shard_shape(lf, self.tp))
                for lf in leaves]
        theirs = [(p, tuple(s)) for p, s in leaf_shapes(self.pcfg, self.tp)]
        if mine != theirs:
            raise RuntimeError("the program's flat layout is not the "
                               f"reference's: {theirs} != {mine}")

    # --- shared pieces ----------------------------------------------------
    def sync(self) -> None:
        import torch
        import torch.distributed as dist
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        if self.world > 1:
            dist.barrier()

    def stage(self, i: int) -> str:
        w = self.traffic["warmup_steps"]
        return "compressed" if w is not None and i >= w else "warmup"

    def lr(self, i: int) -> float:
        from repro_torch.launch.train import lr_schedule
        t = self.traffic
        return lr_schedule(i, t["lr"], t["lr_warmup"])

    def batches(self, seed: int, steps) -> List[dict]:
        import torch
        from portbench import data
        t = self.traffic
        return [{k: torch.from_numpy(v).to(self.dev) for k, v in
                 data.batch_at(self.cfg["vocab"], self.cfg["causal"],
                               t["batch_per_dp"], t["seq"], seed, i,
                               self.dp_rank).items()} for i in steps]

    def gather(self, obj):
        import torch.distributed as dist
        if self.world == 1:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def combine(self, readings: Optional[dict]) -> Optional[dict]:
        """Rank 0's view of every rank's readings of one check: the
        dp-mean losses and, of every other reading, the global leaf
        norms."""
        from portbench import check
        every = self.gather(readings)
        if every[0] is None:
            return None
        return {k: v if k == "loss" else
                check.leaf_norms([r[k] for r in every], self.splits,
                                 self.tp)
                for k, v in every[0].items()}

    def comp_start(self) -> Optional[int]:
        """The step the compression stage starts at, when the traffic has
        one that the set-up steps reach with two compressed steps."""
        from portbench import check
        w = self.traffic["warmup_steps"]
        if w is None:
            return None
        if w < check.STEPS or w + check.COMP_STEPS > \
                self.traffic["setup_steps"]:
            raise ValueError("the traffic's set-up steps must hold the "
                             "three warmup steps of the start check and two "
                             "compressed steps")
        return w

    # --- the program ------------------------------------------------------
    def build(self, seed: int):
        """The program's training state and optimizer from the seed's
        weights."""
        import torch
        from portbench import weights
        from repro_torch.configs import get_optim_recipe
        from repro_torch.convert import shard_params
        from repro_torch.models.transformer import param_specs
        from repro_torch.optim import get_optimizer
        from repro_torch.train.step import init_train_state
        spec = get_optim_recipe(self.traffic["optimizer"])
        optim = get_optimizer(spec.optimizer, compressor=spec.compressor,
                              compressor_kwargs={"block_size": self.block})
        flat = weights.global_params(self.cfg, seed, self.dev, self.tp,
                                      self.ref)
        params = self.ref.unflatten(flat, self.cfg, self.tp)
        if self.tp > 1:
            params = shard_params(params, param_specs(self.pcfg), self.tp,
                                  self.mr)
        ts = init_train_state(self.pcfg, params, optim, self.block,
                              self.n_dp, self.dev, layout="replicated",
                              ctx=self.mesh.parallel_ctx())
        del flat, params
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return ts, optim

    def stepper(self, ts, optim, pool: List[dict], losses: Dict[int, float],
                fault: Optional[str] = None):
        """What ``launch.train.run`` does around each ``train_step``: the
        stage, the batch, the lr schedule, the step, its metrics parked
        and fetched in one copy every ``log_every`` steps."""
        from repro_torch.obs import MetricBuffer
        fn = step_function(fault)
        mbuf = MetricBuffer()
        every = self.traffic["log_every"]
        tp_axes = self.mesh.tp_axes

        def drain():
            for s, rec in mbuf.drain():
                losses[s] = rec["loss"]

        def step(i: int) -> None:
            m = fn(ts, optim, pool[i % len(pool)], self.lr(i),
                   self.stage(i), self.dp_axes, sync=True, pod_axes=(),
                   topology="flat", n_buckets=1, overlap_bwd=False,
                   tp_axes=tp_axes)
            mbuf.push(i, {k: m[k] for k in sorted(m)})
            if i % every == 0:
                drain()
        step.drain = drain
        return step

    def setup_steps(self, ts, optim, step, losses: Dict[int, float]
                    ) -> dict:
        """Every set-up step through the window's own step, and the
        program's readings of the checks (per-leaf sums of squares of
        this rank's vectors): the first gradient as the optimizer got it
        and the parameters' change after three steps; at the switch, m,
        v and the change since the start, and x, m and v on the host;
        the momentum after the first compressed step and the change
        over two.  ``seconds`` is the time the readings took, which is
        the check's and not the set-up's."""
        from portbench import check
        sizes, b1, spent = self.sizes, optim.b1, 0.0
        w = self.comp_start()

        def timed(fn):
            nonlocal spent
            self.sync_device()
            t0 = time.perf_counter()
            out = fn()
            self.sync_device()
            spent += time.perf_counter() - t0
            return out
        x0 = timed(lambda: ts.x.clone())
        out = {"start": {}, "comp": None, "snap": None}
        for i in range(self.traffic["setup_steps"]):
            if i == w:
                out["start"].update(timed(lambda: {
                    "sw_m": check.seg_sumsq(ts.opt.m, sizes),
                    "sw_v": check.seg_sumsq(ts.opt.v, sizes),
                    "sw_dx": check.seg_sumsq(ts.x, sizes, x0)}))
                del x0
                out["snap"] = timed(lambda: {
                    "m": self.host_copy(ts.opt.m),
                    "v": self.host_copy(ts.opt.v),
                    "x": self.host_copy(ts.x)})
            step(i)
            if i == 0:
                out["start"]["g"] = timed(lambda: [
                    s / (1.0 - b1) ** 2
                    for s in check.seg_sumsq(ts.opt.m, sizes)])
            if i == check.STEPS - 1:
                out["start"]["dx"] = timed(
                    lambda: check.seg_sumsq(ts.x, sizes, x0))
                if w is None:
                    del x0
            if w is not None and i == w:
                out["comp"] = {"g": timed(
                    lambda: check.seg_sumsq(ts.opt.m, sizes))}
            if w is not None and i == w + check.COMP_STEPS - 1:
                out["comp"]["dx"] = timed(lambda: check.seg_sumsq(
                    ts.x, sizes, out["snap"]["x"]))
        step.drain()
        out["start"]["loss"] = [losses[i] for i in range(check.STEPS)]
        if w is not None:
            out["comp"]["loss"] = [losses[i] for i in
                                   range(w, w + check.COMP_STEPS)]
        out["seconds"] = spent
        return out

    def program_readings(self, seed: int, fault: Optional[str] = None
                         ) -> dict:
        """A fresh program through the set-up steps alone."""
        ts, optim = self.build(seed)
        pool = self.batches(seed, range(self.traffic["pool"]))
        losses: Dict[int, float] = {}
        step = self.stepper(ts, optim, pool, losses, fault)
        r = self.setup_steps(ts, optim, step, losses)
        del ts, optim, pool, step
        self.free()
        return r

    def host_copy(self, t):
        """A copy of ``t`` in host memory (pinned from a card)."""
        import torch
        if t.device.type != "cuda":
            return t.to("cpu", copy=True)
        return torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=True).copy_(t)

    def sync_device(self) -> None:
        import torch
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def free(self) -> None:
        import gc
        import torch
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # --- the reference ----------------------------------------------------
    @contextlib.contextmanager
    def _strict_f32(self):
        import torch
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
            self.free()

    def _follow(self, opt, seed: int, steps, reads: Dict[int, Callable]
                ) -> tuple:
        """The reference's steps ``steps`` on this rank's rows: its loss
        (dp mean) each step, and ``reads[k](opt)`` after the ``k``-th
        (from 0), merged into one dict.  The model ranks of one dp rank
        share its rows' forward and backward passes and sum their
        gradients."""
        import torch
        import torch.distributed as dist
        ref, cfg = self.ref, self.cfg
        losses, read = [], {}
        pool = self.traffic["pool"]
        rows = self.batches(seed, [i % pool for i in steps])
        for k, (i, batch) in enumerate(zip(steps, rows)):
            t0 = time.perf_counter()
            params = self._global(opt.x)
            loss, grads = ref.loss_and_grads(params, batch, cfg,
                                             self.traffic["ref_rows"],
                                             (self.mr, self.tp))
            del params, batch
            loss_t = torch.tensor([loss], dtype=torch.float64,
                                  device=self.dev)
            if self.tp > 1:
                for g in grads.values():
                    dist.all_reduce(g, group=self.mesh.model_group)
                dist.all_reduce(loss_t, group=self.mesh.model_group)
            g_local = ref.shard_flat(grads, cfg, self.tp, self.mr,
                                     self.d_pad)
            del grads
            if self.n_dp > 1:
                dist.all_reduce(loss_t, group=self.dp_group)
            losses.append(float(loss_t) / self.n_dp)
            if self.stage(i) == "warmup":
                opt.warmup_step(g_local, self.lr(i))
            else:
                opt.compressed_step(g_local, self.lr(i))
            del g_local
            if k in reads:
                read.update(reads[k](opt))
            self.ref_seconds.append(time.perf_counter() - t0)
        return losses, read

    def reference_start(self, seed: int, state_dtype: str = "float32"
                        ) -> dict:
        """The reference from the seed through the first three steps on
        this rank's layout, and on through every warmup step where the
        traffic has a compression stage: the dp ranks meet over
        ``dp_group``, the model ranks' parameters are gathered over the
        model group each step."""
        import torch
        from portbench import check, weights
        from portbench.reference.onebit_adam import OneBitAdam
        with self._strict_f32():
            params = self.ref.unflatten(
                weights.global_params(self.cfg, seed, self.dev, self.tp,
                                      self.ref),
                self.cfg, self.tp)
            opt = OneBitAdam(self.ref.shard_flat(params, self.cfg, self.tp,
                                                 self.mr, self.d_pad),
                             self.n_dp, self.dp_group, self.block,
                             dtype=getattr(torch, state_dtype))
            del params
            x0 = opt.x.to("cpu", copy=True)
            sizes, w = self.sizes, self.comp_start()
            reads = {0: lambda o: {"g": [
                s / (1.0 - o.b1) ** 2 for s in check.seg_sumsq(o.m, sizes)]}}
            reads[check.STEPS - 1] = lambda o: {
                "dx": check.seg_sumsq(o.x, sizes, x0)}
            if w is not None:
                reads[w - 1] = lambda o: {
                    "sw_m": check.seg_sumsq(o.m, sizes),
                    "sw_v": check.seg_sumsq(o.v, sizes),
                    "sw_dx": check.seg_sumsq(o.x, sizes, x0)}
            losses, out = self._follow(
                opt, seed, range(check.STEPS if w is None else w), reads)
            del opt, x0
        return dict(out, loss=losses[:check.STEPS])

    def reference_comp(self, seed: int, snap: dict,
                       state_dtype: str = "float32") -> dict:
        """The reference through the first two compressed steps from the
        program's x, m and v at the switch (``snap``) and its own error
        buffers there (zero)."""
        import torch
        from portbench import check
        from portbench.reference.onebit_adam import OneBitAdam
        w = self.comp_start()
        with self._strict_f32():
            opt = OneBitAdam(torch.zeros(self.d_pad, device=self.dev),
                             self.n_dp, self.dp_group, self.block,
                             dtype=getattr(torch, state_dtype))
            opt.load(snap)
            x0 = opt.x.to("cpu", copy=True)
            losses, out = self._follow(
                opt, seed, range(w, w + check.COMP_STEPS),
                {0: lambda o: {"g": check.seg_sumsq(o.m, self.sizes)}})
            dx = check.seg_sumsq(opt.x, self.sizes, x0)
            del opt, x0
        return dict(out, loss=losses, dx=dx)

    def compare(self, seed: int, prog: dict, ref_start: Optional[dict] = None
                ) -> Dict[str, float]:
        """The numbers of both checks on ``prog`` (its readings), with the
        reference's start (``ref_start``, rank 0's combined view, when
        already taken)."""
        from portbench import check
        if ref_start is None:
            ref_start = self.combine(self.reference_start(seed))
        nums = {}
        start = self.combine(prog["start"])
        if self.rank == 0:
            nums.update(check.start_numbers(start, ref_start))
        if prog["snap"] is not None:
            comp = self.combine(prog["comp"])
            ref_comp = self.combine(self.reference_comp(seed, prog["snap"]))
            if self.rank == 0:
                nums.update(check.numbers(comp, ref_comp, check.COMP))
        return nums

    def _global(self, x):
        """The global float32 leaves of every model rank's flat vector."""
        import torch
        import torch.distributed as dist
        x = x.float()
        if self.tp == 1:
            return self.ref.unflatten(x, self.cfg, 1)
        flats = torch.empty((self.tp, x.shape[0]), dtype=x.dtype,
                            device=x.device)
        dist.all_gather_into_tensor(flats.view(-1), x,
                                    group=self.mesh.model_group)
        joined = self.ref.join_shards(list(flats), self.cfg, self.tp)
        # a replicated leaf is a view of the gathered buffer: copy it out
        return {lf.path: joined[lf.path] if split else
                joined[lf.path].clone()
                for lf, split in zip(self.ref.leaves(self.cfg, self.tp),
                                     self.splits)}


# --------------------------------------------------------------------------
# the traced steps: launch spies and the wire counter
# --------------------------------------------------------------------------

@contextlib.contextmanager
def spies(metrics: List[dict]):
    """Record each call of the wrappers the cell's readers declare
    (``WRAPPER = (module, function)``, ``call_size(*args, **kwargs)``);
    yields {metric: (device kernel name fragment, calls)}."""
    out, undo = {}, []
    for m in metrics:
        mod = _module("metrics", m["name"])
        if not hasattr(mod, "WRAPPER"):
            continue
        owner = importlib.import_module(mod.WRAPPER[0])
        real = getattr(owner, mod.WRAPPER[1])
        calls: List[dict] = []

        def spy(*a, _real=real, _calls=calls, _size=mod.call_size, **k):
            _calls.append(_size(*a, **k))
            return _real(*a, **k)
        setattr(owner, mod.WRAPPER[1], spy)
        undo.append((owner, mod.WRAPPER[1], real))
        out[m["name"]] = (mod.DEVICE_KERNEL, calls)
    try:
        yield out
    finally:
        for owner, attr, real in undo:
            setattr(owner, attr, real)


@contextlib.contextmanager
def wire_counter(groups: Dict[str, object]):
    """Bytes of the tensors handed to ``torch.distributed`` calls, by the
    group they name (``groups``: kind -> process group, None the default
    group)."""
    import torch.distributed as dist
    counts = {k: 0 for k in groups}
    undo = []
    for fname, argi in DIST_CALLS.items():
        real = getattr(dist, fname, None)
        if real is None:
            continue

        def spy(*a, _real=real, _i=argi, **k):
            g = k.get("group")
            t = a[_i] if len(a) > _i else None
            for kind, grp in groups.items():
                if g is grp and t is not None:
                    counts[kind] += t.numel() * t.element_size()
                    break
            return _real(*a, **k)
        setattr(dist, fname, spy)
        undo.append((fname, real))
    try:
        yield counts
    finally:
        for fname, real in undo:
            setattr(dist, fname, real)


# --------------------------------------------------------------------------
# the run of one rank
# --------------------------------------------------------------------------

def bench_rank(rank: int, world: int, job: dict) -> Optional[dict]:
    """Set-up, window, traced steps and comparison on one rank; rank 0's
    record (None elsewhere)."""
    import torch
    marks = [("imports and cell", time.time())]
    r = Rank(rank, world, job)
    r.sync()
    marks.append(("device and mesh", time.time()))
    t = r.traffic
    seed = job["seed"]
    ts, optim = r.build(seed)
    r.sync()
    marks.append(("weights and state", time.time()))
    pool = r.batches(seed, range(t["pool"]))
    marks.append(("batch pool", time.time()))
    losses: Dict[int, float] = {}
    step = r.stepper(ts, optim, pool, losses, job.get("fault"))
    prog = r.setup_steps(ts, optim, step, losses)
    marks.append(("set-up steps", time.time()))
    on_card = r.dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(r.dev)
    r.sync()
    t_setup_end = time.time()
    t0 = time.perf_counter()
    i = t["setup_steps"]
    while True:
        step(i)
        i += 1
        stop = time.perf_counter() - t0 >= job["seconds"]
        if world > 1:
            import torch.distributed as dist
            flag = torch.tensor([int(stop)])
            dist.broadcast(flag, src=0, group=r.stop_group)
            stop = bool(flag.item())
        if stop:
            break
    step.drain()
    r.sync()
    elapsed = time.perf_counter() - t0
    n_window = i - t["setup_steps"]
    peak = torch.cuda.max_memory_allocated(r.dev) if on_card else 0
    traced = None
    if job["trace"]:
        traced = trace_steps(r, step, i, job)
        i += t["traced_steps"]
    window_losses = [losses[s] for s in range(t["setup_steps"], i)]
    del ts, optim, pool, step
    r.free()
    nums = r.compare(seed, prog)
    records = r.gather({"peak": peak, "traced": traced,
                        "forbidden": forbidden_modules(),
                        "check_s": prog["seconds"], "marks": marks,
                        "ref_steps_s": r.ref_seconds,
                        "device": torch.cuda.get_device_name(r.dev)
                        if on_card else "cpu"})
    if world > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    if rank != 0:
        return None
    return {"setup_end": t_setup_end, "elapsed": elapsed, "n_dp": r.n_dp,
            "window_steps": n_window, "losses": window_losses,
            "numbers": nums, "ranks": records}


def trace_steps(r: Rank, step, i0: int, job: dict) -> dict:
    """``traced_steps`` steps under the profiler; this rank's fold."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from portbench import tracefold
    from repro_torch.obs.trace import set_tracing
    k = r.traffic["traced_steps"]
    groups = {"dp": r.dp_group} if r.n_dp > 1 else {}
    if r.tp > 1:
        groups["model"] = r.mesh.model_group
    acts = [ProfilerActivity.CPU]
    if r.dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    path = os.path.join(tempfile.gettempdir(),
                        f"portbench_trace_{os.getpid()}_rank{r.rank}.json")
    set_tracing(True)
    try:
        with spies(job["cell"]["per_layer"]) as spied, \
                wire_counter(groups) as wire:
            r.sync()
            prof = profile(activities=acts)
            prof.start()
            with record_function(tracefold.WINDOW_RANGE):
                for s in range(i0, i0 + k):
                    with record_function(tracefold.STEP_RANGE):
                        step(s)
                step.drain()
                if r.dev.type == "cuda":
                    torch.cuda.synchronize(r.dev)
            prof.stop()
            prof.export_chrome_trace(path)
            del prof
            calls = {name: (frag, list(c)) for name, (frag, c) in
                     spied.items()}
            wire = dict(wire)
    finally:
        set_tracing(False)
    try:
        out = tracefold.fold(tracefold.load_events(path), calls)
    finally:
        os.remove(path)
    out["wire_bytes_per_step"] = {kind: n / k for kind, n in wire.items()}
    return out


def calibrate_rank(rank: int, world: int, job: dict) -> Optional[dict]:
    """For each seed: the program's numbers (``sound``), the control's
    (the reference with its state a precision step lower, against the
    reference, from the same seed and from the sound program's state at
    the switch), and each planted fault's."""
    from portbench import check
    r = Rank(rank, world, job)
    out = []
    faults = ["half_batch"] + (["no_exchange"] if r.n_dp > 1 else [])
    low = CONTROL_DTYPE
    for seed in job["seeds"]:
        t0 = time.perf_counter()
        ref_start = r.combine(r.reference_start(seed))
        prog = r.program_readings(seed)
        row = {"seed": seed, "sound": r.compare(seed, prog, ref_start)}
        control = r.combine(r.reference_start(seed, low))
        nums = {}
        if rank == 0:
            nums.update(check.start_numbers(control, ref_start))
        if prog["snap"] is not None:
            ref_comp = r.combine(r.reference_comp(seed, prog["snap"]))
            ctl_comp = r.combine(r.reference_comp(seed, prog["snap"], low))
            if rank == 0:
                nums.update(check.numbers(ctl_comp, ref_comp, check.COMP))
        row["control"] = nums
        del prog
        for f in faults:
            row[f] = r.compare(seed, r.program_readings(seed, f), ref_start)
        row["seconds"] = time.perf_counter() - t0
        out.append(row)
        if rank == 0:
            print(json.dumps(row), flush=True)
    if world > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    return {"rows": out} if rank == 0 else None


MODES = {"bench": bench_rank, "calibrate": calibrate_rank}


def _spawned(rank: int, world: int, job: dict) -> None:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if job["device"] == "cpu":
        import torch
        torch.set_num_threads(1)
    res = MODES[job["mode"]](rank, world, job)
    if res is not None:
        with open(os.path.join(job["workdir"], "rank0.json"), "w") as f:
            json.dump(res, f)


def run_job(job: dict) -> dict:
    """Run ``job`` on ``job["cell"]["chips"]`` ranks: in this process on
    one, spawned processes on more; rank 0's record."""
    world = job["cell"]["chips"]
    if world == 1:
        return MODES[job["mode"]](0, 1, job)
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="portbench_") as work:
        job = dict(job, workdir=work,
                   rendezvous=os.path.join(work, "rendezvous"))
        if job["device"] == "cuda":
            from repro_torch.kernels import build
            build.build()          # once, before the ranks look for it
        mp.start_processes(_spawned, args=(world, job), nprocs=world,
                           start_method="spawn")
        with open(os.path.join(work, "rank0.json")) as f:
            return json.load(f)


# --------------------------------------------------------------------------
# the record -> the result line
# --------------------------------------------------------------------------

def result(cell: dict, job: dict, rec: dict, t_start: float) -> dict:
    """The result object of one run from rank 0's record."""
    from portbench import check
    traced = [r["traced"] for r in rec["ranks"]]
    tokens = cell["traffic"]["batch_per_dp"] * cell["traffic"]["seq"] \
        * rec["n_dp"]
    peaks = json.loads((HERE / "peaks.json").read_text())
    # the check's own set-up work (the readings and the state copied at
    # the switch) is not the program's
    run = {"cell": cell, "chips": cell["chips"], "peaks": peaks,
           "setup_s": rec["setup_end"] - t_start
           - max(r["check_s"] for r in rec["ranks"]),
           "window_s": rec["elapsed"], "window_steps": rec["window_steps"],
           "tokens_per_step": tokens,
           "step_flops": _module("flops", cell["config"]["flops"])
           .step_flops(cell["config"], tokens, cell["traffic"]["seq"]),
           "peak_bytes": max(r["peak"] for r in rec["ranks"]),
           "traced": traced if job["trace"] else None}
    wanted = cell["per_layer"] if job["trace"] else cell["end_to_end"]
    metrics = {}
    for m in wanted:
        v = _module("metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct, checks = check.verdict(rec["numbers"], cell["limits"])
    losses = rec["losses"]
    device = {"platform": "gpu", "kind": rec["ranks"][0]["device"],
              "count": cell["chips"],
              "memory_peak_bytes": run["peak_bytes"]}
    out = {"correct": correct, "attempted": len(losses),
           "failed": sum(not math.isfinite(x) for x in losses),
           "metrics": metrics, "device": device}
    if job["trace"]:
        device["busy_s"] = sum(t["busy_s"] for t in traced) / len(traced)
        device["window_s"] = traced[0]["window_s"]
        out["breakdown"] = {"device_ops": traced[0]["device_ops"],
                            "idle_gaps": traced[0]["idle_gaps"]}
    out["checks"] = checks
    return out
