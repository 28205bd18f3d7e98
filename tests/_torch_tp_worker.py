"""Spawned gloo ranks for the tensor-parallel tests (tests/test_torch_tp.py,
tests/test_torch_tp_train.py and the card tests of test_torch_cuda.py).
They import torch and the port only.

``collectives_main``: the eight collectives of ``models.common`` on a
model axis of ``world`` ranks, each on this rank's seeded input, forward
and backward (a seeded cotangent); saves ``coll<rank>.npz``.

``model_main``: per case of ``cases<world>.json`` (an arch's config
fields, a mesh ``NxT``, ``sp``, the ``data`` file), this rank's loss and
flat gradient of the port's model over its shards of the global params in
``<data>.npz`` (the reference's tree at tp), on the batch saved there
(split over the dp ranks); saves ``<case>_r<rank>.npz``.

``run_main``: the port's ``launch.train.run`` per entry of
``runs<world>.json``,
with every call of ``core.comm.compressed_exchange`` recorded (its
inputs, EF slots and outputs) for the first ``record`` calls; saves the
losses, the parameters and the state, and the records to
``<name>_r<rank>.npz``.
"""
import dataclasses
import json
import os

import numpy as np
import torch
import torch.distributed as dist


def _init(rank: int, world: int, workdir: str, tag: str, backend="gloo"):
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        os.environ["LOCAL_RANK"] = str(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(
            workdir, f"rendezvous_{tag}_{backend}"),
        rank=rank, world_size=world)
    return dev


COLL_SHAPE = (2, 8, 6)       # (B, S, d): S splits over 2 and 4 ranks


def coll_inputs(rank: int, shape=COLL_SHAPE):
    rng = np.random.default_rng([7, rank])
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def collectives_main(rank: int, world: int, workdir: str) -> None:
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.models import common as C
    _init(rank, world, workdir, f"coll{world}")
    try:
        mesh = build_mesh(f"1x{world}")
        out = {}
        for sp in (False, True):
            ctx = mesh.parallel_ctx(sp=sp)
            x_np, ct_np = coll_inputs(rank)
            s = COLL_SHAPE[1]
            ops = {
                "g_copy": (lambda x: C.g_copy(x, ctx), ct_np),
                "f_reduce": (lambda x: C.f_reduce(x, ctx), ct_np),
                "rep_param": (lambda x: C.rep_param(x, ctx), ct_np),
                "pmean": (lambda x: C.pmean(x, ctx), ct_np),
                "sp_gather": (lambda x: C.sp_gather(x[:, :s // world], ctx),
                              ct_np),
                "sp_scatter": (lambda x: C.sp_scatter(x, ctx),
                               ct_np[:, :s // world]),
                "sp_slice": (lambda x: C.sp_slice(x, ctx),
                             ct_np[:, :s // world]),
            }
            if world == 4:
                ops["grouped_param2"] = (
                    lambda x: C.grouped_param(x, ctx, 2), ct_np)
                ops["grouped_param4"] = (
                    lambda x: C.grouped_param(x, ctx, 4), ct_np)
            for name, (fn, ct) in ops.items():
                x = torch.from_numpy(x_np).requires_grad_(True)
                y = fn(x)
                y.backward(torch.from_numpy(np.ascontiguousarray(ct)))
                key = f"{name}_sp{int(sp)}"
                out[key + "_y"] = y.detach().numpy()
                out[key + "_g"] = x.grad.numpy()
        out["tp_rank"] = np.asarray(C.tp_rank(mesh.parallel_ctx()))
        np.savez(os.path.join(workdir, f"coll{world}_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _config(fields: dict):
    from repro_torch.configs import get_config
    cfg = get_config(fields.pop("arch"))
    return dataclasses.replace(cfg, **fields)


def model_main(rank: int, world: int, workdir: str, backend="gloo"
               ) -> None:
    from repro_torch.convert import shard_params
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.models.transformer import (Transformer, flat_size,
                                                loss_fn, param_specs)
    from repro_torch.convert import flat_from_params
    dev = _init(rank, world, workdir, f"model{world}", backend)
    try:
        with open(os.path.join(workdir, f"cases{world}.json")) as f:
            cases = json.load(f)
        meshes = {}
        for name, case in cases.items():
            cfg = _config(dict(case["cfg"]))
            spec = case["mesh"]
            if spec not in meshes:
                meshes[spec] = build_mesh(spec)
            mesh = meshes[spec]
            ctx = mesh.parallel_ctx(sp=case["sp"])
            data = np.load(os.path.join(workdir, f"{case['data']}.npz"))
            glob = {k[2:]: torch.from_numpy(data[k]) for k in data.files
                    if k.startswith("p:")}
            batch = {k[2:]: torch.from_numpy(data[k]).to(dev)
                     for k in data.files if k.startswith("b:")}
            if mesh.n_dp > 1:
                b = next(iter(batch.values())).shape[0] // mesh.n_dp
                batch = {k: v[mesh.dp_rank * b:(mesh.dp_rank + 1) * b]
                         for k, v in batch.items()}
            local = shard_params(glob, param_specs(cfg), mesh.tp,
                                 mesh.model_rank)
            x = flat_from_params(local).to(dev)
            assert x.shape[0] == flat_size(cfg, mesh.tp)
            g = torch.zeros_like(x)
            model = Transformer(cfg, x, ctx)
            model.bind_grads(g)
            tot, met = loss_fn(model, batch)
            tot.backward()
            np.savez(os.path.join(workdir, f"{name}_r{rank}.npz"),
                     total=tot.detach().cpu().numpy(),
                     loss=met["loss"].detach().cpu().numpy(),
                     grad=g.cpu().numpy())
    finally:
        dist.destroy_process_group()


def run_main(rank: int, world: int, workdir: str) -> None:
    from repro_torch.core import comm
    from repro_torch.launch import train as LT
    _init(rank, world, workdir, f"run{world}")
    try:
        with open(os.path.join(workdir, f"runs{world}.json")) as f:
            runs = json.load(f)
        real = comm.compressed_exchange
        for name, kw in runs.items():
            kw = dict(kw)
            n_rec = kw.pop("record", 0)
            recs = []

            def spy(m_local, errs, *a, **k):
                before = {e: t.clone() for e, t in errs.items()}
                m_in = m_local.clone()
                out, new = real(m_local, errs, *a, **k)
                if len(recs) < n_rec:
                    recs.append((m_in, before, out.clone(),
                                 {e: t.clone() for e, t in new.items()}))
                return out, new
            comm.compressed_exchange = spy
            try:
                res = LT.run(device="cpu", verbose=False, **kw)
            finally:
                comm.compressed_exchange = real
            ts = res["state"]
            out = {"losses": np.asarray([h["loss"] for h in
                                         res["history"]]),
                   "x": ts.x.numpy(), "d_pad": np.asarray(res["d_pad"]),
                   "n_buckets": np.asarray(res["n_buckets"]),
                   "overlap_bwd": np.asarray(bool(res["overlap_bwd"])),
                   "topology": np.asarray(res["topology"])}
            for k, v in ts.opt.items():
                out[f"opt_{k}"] = v.numpy()
            for i, (m_in, before, o, new) in enumerate(recs):
                out[f"rec{i}_m"] = m_in.numpy()
                out[f"rec{i}_out"] = o.numpy()
                for e in ("worker", "server"):
                    out[f"rec{i}_{e}_in"] = before[e].numpy()
                    out[f"rec{i}_{e}_out"] = new[e].numpy()
            np.savez(os.path.join(workdir, f"{name}_r{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _leaf_err(a: torch.Tensor, b: torch.Tensor, shapes) -> float:
    """Worst leaf's max |a - b| / max |b| of two flat vectors over the
    leaves ``shapes`` (their start)."""
    worst, off = 0.0, 0
    for _, shp in shapes:
        n = int(np.prod(shp))
        ref = b[off:off + n]
        worst = max(worst, float((a[off:off + n] - ref).abs().max())
                    / (float(ref.abs().max()) + 1e-8))
        off += n
    return worst


def _busy_ms(prof) -> tuple:
    """(device busy ms as the union of the kernels' intervals, kernel
    count) of one torch.profiler trace."""
    from torch.autograd import DeviceType
    iv = sorted((e.time_range.start, e.time_range.end) for e in
                prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in iv:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, len(iv)


def _matmul_nccl_ms(prof) -> dict:
    """Device ms of the cuBLAS matmul kernels and of the NCCL kernels in
    one torch.profiler trace, with their counts (kernels told apart by
    name, as chip_smoke.py's groups)."""
    from torch.autograd import DeviceType
    out = {"matmul_ms": 0.0, "matmul_kernels": 0, "nccl_ms": 0.0,
           "nccl_kernels": 0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        low = e.name.lower()
        kind = "nccl" if "nccl" in low else "matmul" if any(
            k in low for k in ("gemm", "xmma", "cutlass", "sm90_",
                               "nvjet")) else None
        if kind:
            out[f"{kind}_ms"] += e.time_range.elapsed_us() / 1e3
            out[f"{kind}_kernels"] += 1
    return out


def _routes(T, calls):
    """A spy on ``models.transformer.moe_forward`` recording each call's
    top-k expert choices."""
    real = T.moe_forward

    def spy(p, x, cfg, *a, **k):
        with torch.no_grad():
            logits = x.reshape(-1, x.shape[-1]).float() @ p["router"].float()
            calls.append(torch.topk(torch.softmax(logits, -1),
                                    cfg.moe_top_k, -1)[1].sort(-1)[0].cpu())
        return real(p, x, cfg, *a, **k)
    return real, spy


def card_main(rank: int, world: int, workdir: str, backend="nccl") -> None:
    """One path of ``card.json`` on ``world`` ranks (one card a rank under
    NCCL): the step-0 parity of the tp model against the tp = 1 model of
    the same global f32 params on this rank's dp batch (loss, every leaf
    of this rank's gradient shard; the MoE tokens rerouted between the
    two counted and held out of the loss), then ``launch.train.run`` on the mesh: step ms, losses, peak
    bytes, launch counts, one profiled compressed step (device busy and
    idle share), wire bytes, whether the dp replicas agree bitwise and
    how far the replicated leaves drifted across the model ranks; with a
    ``twin`` in the spec, the run again with those options changed and
    whether the two agree bitwise.  Saves ``card_r<rank>.json``."""
    import dataclasses as dc
    import time
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, register
    from repro_torch.convert import (flat_from_params, params_from_flat,
                                     shard_params)
    from repro_torch.data import SyntheticStream
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.models import transformer as T
    from repro_torch.plan.executor import all_gather_into
    from repro_torch.train.step import train_step
    dev = _init(rank, world, workdir, "card", backend)
    on_card = dev.type == "cuda"
    try:
        with open(os.path.join(workdir, "card.json")) as f:
            spec = json.load(f)
        base = get_config(spec["base"])
        cfg = register(dc.replace(base, name=spec["name"], **spec["cfg"]))
        mesh = build_mesh(spec["mesh"])
        tp, mr = mesh.tp, mesh.model_rank
        out = {"rank": rank, "model_rank": mr, "dp_rank": mesh.dp_rank,
               "tp": tp, "n_dp": mesh.n_dp}
        # --- step-0 parity in f32 against tp = 1 on this card -------------
        par = spec["parity"]
        pcfg = dc.replace(cfg, compute_dtype="float32",
                          **par.get("cfg", {}))
        assert T.global_leaf_shapes(pcfg, tp) == T.global_leaf_shapes(
            pcfg, 1), "the tp tree is not the tp = 1 tree"
        gen = torch.Generator(device=dev).manual_seed(spec["seed"])
        batch = SyntheticStream(
            pcfg, InputShape("p", par["seq"], par["batch"] * mesh.n_dp,
                             "train"), seed=spec["seed"],
            shard=mesh.dp_rank, n_shards=mesh.n_dp, device=dev).batch_at(0)
        x1 = flat_from_params(T.init_params(pcfg, gen, device=dev))
        specs = T.param_specs(pcfg)
        s1, s_tp = T.leaf_shapes(pcfg, 1), T.leaf_shapes(pcfg, tp)
        x2 = flat_from_params(shard_params(params_from_flat(x1, s1), specs,
                                           tp, mr))
        g1, g2 = torch.zeros_like(x1), torch.zeros_like(x2)
        m1 = T.Transformer(pcfg, x1)
        m2 = T.Transformer(pcfg, x2, mesh.parallel_ctx())
        m1.bind_grads(g1)
        m2.bind_grads(g2)

        def pass_of(model, grad, b):
            """(total, routes, seconds) of one forward + backward."""
            routes = []
            real, spy = _routes(T, routes)
            T.moe_forward = spy
            t0 = time.perf_counter()
            grad.zero_()
            try:
                tot, _ = T.loss_fn(model, b)
                tot.backward()
            finally:
                T.moe_forward = real
            if on_card:
                torch.cuda.synchronize()
            return float(tot.detach()), routes, time.perf_counter() - t0

        # a token that routes to another expert on the two sides (a near
        # tie in its top-k, broken the other way by the sums' order) is
        # counted, then held out of the loss (loss_mask) and both passes
        # run again: routing does not depend on the mask
        held = batch
        for attempt in range(2):
            loss1, routes1, out["parity_tp1_s"] = pass_of(m1, g1, held)
            loss2, routes2, out["parity_tp_s"] = pass_of(m2, g2, held)
            flips = torch.zeros(batch["labels"].numel(), dtype=torch.bool)
            for a, b in zip(routes1, routes2):
                flips |= (a != b).any(-1)
            if attempt == 0:
                out["rerouted_tokens"] = int(flips.sum())
                out["routed_tokens"] = int(flips.numel()) if routes1 else 0
            if not flips.any() or attempt:
                break
            mask = (~flips).to(torch.float32).reshape(
                batch["labels"].shape).to(dev)
            held = dict(batch, loss_mask=mask)
        g1 = flat_from_params(shard_params(params_from_flat(g1, s1), specs,
                                           tp, mr))
        out.update(loss_tp1=loss1, loss_tp=loss2,
                   grad_max_rel_err=_leaf_err(g2, g1, s_tp))
        del m1, x1, m2, x2, g2, g1, batch, held
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        # --- the run through the entry point -------------------------------
        kw = dict(spec["run"])
        t0 = time.perf_counter()
        res = LT.run(arch=spec["name"], mesh=spec["mesh"],
                     device=dev.type, verbose=rank == 0, log_every=1, **kw)
        out["run_s"] = time.perf_counter() - t0
        hist = res["history"]
        out.update(
            losses=[float(h["loss"]) for h in hist],
            stages=[h["stage"] for h in hist],
            step_ms=[float(h["ms"]) for h in hist],
            launches=dict(res["launches"]), d=res["d"],
            d_pad=res["d_pad"], flat_size_tp1=T.flat_size(cfg, 1),
            peak_bytes=(torch.cuda.max_memory_allocated(dev) if on_card
                        else None))
        warm, comp = LT.run_plans(res["optimizer"], res["d_pad"],
                                  mesh.axes, mesh.sizes, res["topology"])
        out["wire_bytes"] = {"warmup": float(warm.wire_send_bytes()),
                             "compressed": float(comp.wire_send_bytes())}
        ts = res["state"]
        # the dp replicas of this model rank and the replicated leaves
        xs = torch.empty((world, ts.x.shape[0]), dtype=ts.x.dtype,
                         device=dev)
        all_gather_into(xs.view(-1), ts.x)
        same = [bool(torch.equal(xs[r], ts.x)) for r in range(world)
                if r % tp == mr]
        drift, off = 0.0, 0
        for path, shp in T.leaf_shapes(cfg, tp):
            n = int(np.prod(shp))
            if specs[path] is None:
                seg = xs[:, off:off + n]
                drift = max(drift, float((seg - seg[0]).abs().max()))
            off += n
        out.update(dp_replicas_bitwise=all(same),
                   replicated_leaves_max_drift=drift,
                   n_buckets=res["n_buckets"],
                   overlap_bwd=bool(res["overlap_bwd"]))
        del xs
        if spec.get("twin"):
            # the same run with the ``twin`` options changed; the two are
            # compared bitwise (losses and this rank's parameters)
            x_first = ts.x.clone()
            del ts, res
            if on_card:
                torch.cuda.empty_cache()
            res = LT.run(arch=spec["name"], mesh=spec["mesh"],
                         device=dev.type, verbose=rank == 0, log_every=1,
                         **dict(kw, **spec["twin"]))
            ts = res["state"]
            twin = [float(h["loss"]) for h in res["history"]]
            out.update(twin_losses=twin,
                       twin_overlap_bwd=bool(res["overlap_bwd"]),
                       twin_step_ms=[float(h["ms"]) for h in
                                     res["history"]],
                       twin_bitwise=(twin == out["losses"]
                                     and bool(torch.equal(ts.x, x_first))))
            del x_first
        # --- one more compressed step under the profiler -------------------
        if on_card and spec.get("profile", True):
            from torch.profiler import ProfilerActivity, profile
            stream = SyntheticStream(
                cfg, InputShape("p", kw["seq"], kw["batch"], "train"),
                seed=1, shard=mesh.dp_rank, n_shards=mesh.n_dp, device=dev)
            b = stream.batch_at(0)
            dp_axes = mesh.axes if mesh.n_dp > 1 else ()
            torch.cuda.synchronize()
            dist.barrier()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                train_step(ts, res["optimizer"], b, 1e-4, "compressed",
                           dp_axes, tp_axes=mesh.tp_axes)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy, n_k = _busy_ms(prof)
            out["profile"] = {"wall_ms": wall, "device_busy_ms": busy,
                              "idle_share": 1.0 - busy / wall,
                              "n_kernels": n_k, **_matmul_nccl_ms(prof)}
        with open(os.path.join(workdir, f"card_r{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


# the reduced configs of the NCCL SP / TP parity, with their SP-vs-TP
# tolerances (the reference's TestSequenceParallel)
TP_SP_ARCHS = {"llama3.2-3b-smoke": 1e-5, "falcon-mamba-7b-smoke": 1e-5,
               "internvl2-2b-smoke": 1e-5, "mixtral-8x22b-smoke": 0.2}


def reduced_parity(workdir, world: int, backend: str, card) -> dict:
    """The reduced configs of :data:`TP_SP_ARCHS` on ``world`` (2 or 4)
    ranks, a model axis of 2 (mesh ``1x2`` or ``2x2``), in f32 with TF32
    off, each rank on its dp part of one batch of 4 x 32: the TP model's
    loss and every leaf of each rank's gradient shard against the tp = 1
    model of the same global params on ``card`` (loss rtol 1e-5, gradient
    max-relative error 1e-4, the reference's TP-parity tolerances; MoE
    capacity factor 64, so no token drops), and the sequence-parallel
    model against the TP one at the SP tolerances.  Raises on a miss;
    returns each arch's worst (TP, SP) errors."""
    import math
    import pathlib
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.convert import (flat_from_params, params_from_flat,
                                     shard_params)
    from repro_torch.data import SyntheticStream
    from repro_torch.models import transformer as TT
    workdir = pathlib.Path(workdir)
    tp, n_dp = 2, world // 2
    rows = 4 // n_dp
    torch.backends.cuda.matmul.allow_tf32 = False
    cases, want = {}, {}
    for arch in TP_SP_ARCHS:
        fields = {"capacity_factor": 64.0}
        cfg = dataclasses.replace(get_config(arch), **fields)
        glob = TT.init_params(cfg, torch.Generator().manual_seed(0), tp=tp)
        batch = SyntheticStream(cfg, InputShape("p", 32, 4, "train"),
                                seed=0).batch_at(0)
        arrays = {f"p:{k}": v.numpy() for k, v in glob.items()}
        arrays.update({f"b:{k}": v.numpy() for k, v in batch.items()})
        np.savez(workdir / f"tp_{arch}.npz", **arrays)
        for sp in (False, True):
            cases[f"{'sp' if sp else 'tp'}_{arch}"] = {
                "cfg": dict(arch=arch, **fields),
                "mesh": f"{n_dp}x{tp}", "sp": sp, "data": f"tp_{arch}"}
        # tp = 1 on one card, each dp part of the batch
        x = flat_from_params(glob).to(card)
        for i in range(n_dp):
            g = torch.zeros_like(x)
            model = TT.Transformer(cfg, x)
            model.bind_grads(g)
            tot, _ = TT.loss_fn(model, {k: v[i * rows:(i + 1) * rows]
                                        .to(card) for k, v in
                                        batch.items()})
            tot.backward()
            gp = params_from_flat(g.cpu(), TT.leaf_shapes(cfg, 1))
            want[(arch, i)] = (float(tot.detach()), [
                flat_from_params(shard_params(gp, TT.param_specs(cfg), tp,
                                              m)).numpy()
                for m in range(tp)])
    with open(workdir / f"cases{world}.json", "w") as f:
        json.dump(cases, f)
    mp.start_processes(model_main, args=(world, str(workdir), backend),
                       nprocs=world, start_method="spawn")
    worst = {}
    for arch, sp_tol in TP_SP_ARCHS.items():
        shapes = TT.leaf_shapes(get_config(arch), tp)
        for r in range(world):
            i, m = divmod(r, tp)
            tot, gw = want[(arch, i)]
            tp_r = np.load(workdir / f"tp_{arch}_r{r}.npz")
            sp_r = np.load(workdir / f"sp_{arch}_r{r}.npz")
            np.testing.assert_allclose(float(tp_r["total"]), tot, rtol=1e-5)
            assert abs(float(sp_r["total"]) - float(tp_r["total"])) < 1e-3
            e_tp = e_sp = 0.0
            off = 0
            for _, shp in shapes:
                n = math.prod(shp)
                ref, tpg = gw[m][off:off + n], tp_r["grad"][off:off + n]
                e_tp = max(e_tp, float(np.abs(tpg - ref).max())
                           / (float(np.abs(ref).max()) + 1e-8))
                e_sp = max(e_sp, float(np.abs(sp_r["grad"][off:off + n]
                                              - tpg).max())
                           / (float(np.abs(tpg).max()) + 1e-8))
                off += n
            assert e_tp < 1e-4, (arch, r, e_tp)
            assert e_sp < sp_tol, (arch, r, e_sp)
            w = worst.get(arch, (0.0, 0.0))
            worst[arch] = (max(w[0], e_tp), max(w[1], e_sp))
    return worst
