"""Spawned ranks of the tensor-parallel serving tests
(tests/test_torch_tp_serve.py over gloo, the four-card test of
tests/test_torch_cuda.py over NCCL).  They import torch and the port only.

``serve_main``: per case of ``cases<world>.json`` (an arch, its config
fields, a mesh ``NxT``, the global params file at T, the inputs file, the
prompt and cache lengths, the decode positions, ``seq_sharded``), this
rank's part of serving through ``train.step.make_serve_step`` over its
shards (``convert.shard_params``):

  * batch-sharded cases: the prefill step's logits (this dp rank's rows,
    every vocab shard joined), ``models.transformer.prefill``'s caches of
    this rank under ``mesh.parallel_ctx()`` (checked against the decode
    step's ``init_caches`` shapes), then one decode step a position from
    them;
  * seq-sharded cases: decode steps from the step's zero caches;

and for a MoE arch the top-k expert choices of every MoE call of the
prefill and of each decode step (``routes_<phase>``).  Saves
``<case>_r<rank>.npz``: ``prefill``, ``s<i>``, ``c:<leaf>`` (the
prefill's caches), ``f:<leaf>`` (the caches after the last step).

``path_s_main``: path S on four cards (``path_s.json``): granite-34b at
full size on a 1 x 4 mesh in bf16 with attn_impl="pallas", each rank's
shards drawn on its card superblock by superblock (:func:`rank_params`,
one global model from one seed): the prefill step timed and its flash
launches counted, then greedy decode steps timed, one of them profiled;
and the same model cut in depth, in f32 with TF32 off, its prefill and
decode steps at tp 4 beside rank 0's tp = 1 model.  Saves
``path_s_r<rank>.json``.

The helpers the tests share: :func:`make_inputs`, :func:`expand_kv` (a
tp global tree from the tp = 1 one), :func:`port_reference` (tp = 1
serving of the same inputs), :func:`join_caches` and :func:`check_case`.
"""
import dataclasses
import json
import os

import numpy as np
import torch

from _torch_hier_worker import _init


def make_inputs(cfg, seed: int, b: int, s: int, n: int):
    """Prefill inputs of ``s`` positions and ``n`` one-position decode
    inputs, numpy from ``seed``: tokens, or frames for the audio stub; the
    VLM's prefill also takes its patch prefix."""
    rng = np.random.default_rng(seed)
    if cfg.embed_kind == "embeddings":
        x = rng.standard_normal((b, s + n, cfg.d_model)).astype(np.float32)
        key = "embeddings"
    else:
        x = rng.integers(0, cfg.vocab, (b, s + n)).astype(np.int32)
        key = "tokens"
    pre = {key: x[:, :s]}
    if cfg.embed_kind == "prefix":
        pre["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_prefix, cfg.d_model)).astype(np.float32)
    return pre, [{key: x[:, s + i:s + i + 1]} for i in range(n)]


def kv_rep(cfg, tp: int) -> int:
    from repro_torch.models.attention import shard_dims
    return shard_dims(cfg, tp)[2] if cfg.n_heads else 1


def expand_kv(one: dict, cfg, tp: int) -> dict:
    """The tp global tree of the tp = 1 tree ``one``: each kv head's
    columns repeated for its duplicates."""
    from repro_torch.models import transformer as T
    out = dict(one)
    rep, hd = kv_rep(cfg, tp), cfg.head_dim
    if rep > 1:
        for p, t in one.items():
            if p.endswith(("mixer.wk", "mixer.wv")):
                n, d = t.shape[:2]
                out[p] = t.reshape(n, d, -1, 1, hd).expand(
                    n, d, t.shape[2] // hd, rep, hd).reshape(n, d, -1)
    assert {p: tuple(t.shape) for p, t in out.items()} == \
        dict(T.global_leaf_shapes(cfg, tp))
    return out


def case_plan(cfg, seq_sharded: bool, batch=2, prompt=72, steps=4,
              seq_positions=(0, 1, 2, 15, 16, 17), seq_slots=32) -> dict:
    """The batch, prompt and cache lengths and decode positions of a
    case: a prompt of ``prompt`` tokens (after the VLM's patches) and
    ``steps`` teacher-forced steps, or, seq-sharded, one sequence decoded
    at ``seq_positions`` from zero caches of ``seq_slots`` slots."""
    if seq_sharded:
        return dict(batch=1, prompt=0, cache_len=seq_slots,
                    positions=list(seq_positions))
    n_pre = cfg.n_prefix if cfg.embed_kind == "prefix" else 0
    return dict(batch=batch, prompt=prompt, cache_len=n_pre + prompt + steps,
                positions=[n_pre + prompt + i for i in range(steps)])


def port_reference(cfg, params, pre, steps, plan, dev) -> dict:
    """The port's tp = 1 serving of the same inputs on ``dev``: what the
    tests hold the mesh to when the reference package is absent (the
    card).  Same keys as the CPU test's reference runs."""
    from repro_torch.models import transformer as T
    routes, moe = [], T.moe_forward

    def spy(p, x, c, *a, **kw):
        logits = x.reshape(-1, x.shape[-1]).float() @ p["router"].float()
        routes.append(torch.topk(torch.softmax(logits, -1), c.moe_top_k,
                                 -1)[1].cpu().numpy())
        return moe(p, x, c, *a, **kw)

    def take():
        out = np.stack(routes) if routes else None
        routes.clear()
        return out

    def on(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    T.moe_forward = spy
    out = dict(plan)
    try:
        with torch.inference_mode():
            if plan["prompt"] == 0:
                caches = T.init_caches(cfg, plan["batch"], plan["cache_len"],
                                       torch.float32, dev)
            else:
                logits, caches = T.prefill(params, on(pre), cfg,
                                           cache_len=plan["cache_len"])
                out["prefill"] = logits.float().cpu().numpy()
                out["caches"] = {n: {k: t.float().cpu().clone().numpy()
                                     for k, t in lv.items()}
                                 for n, lv in caches.items()}
                out["routes_prefill"] = take()
            for i, (pos, st) in enumerate(zip(plan["positions"], steps)):
                logits, caches = T.decode_step(params, on(st), caches, pos,
                                               cfg)
                out[f"s{i}"] = logits.float().cpu().numpy()
                out[f"routes_s{i}"] = take()
            out["final"] = {n: {k: t.float().cpu().numpy()
                                for k, t in lv.items()}
                            for n, lv in caches.items()}
    finally:
        T.moe_forward = moe
    return out


def join_caches(ranks, cfg, mesh: str, tag: str, seq_sharded: bool) -> dict:
    """Each cache leaf of every rank (dp index major) joined over the
    model axis and then the dp axis, the duplicate kv heads dropped: the
    tp = 1 global caches."""
    from repro_torch.models import transformer as T
    n_dp, tp = (int(x) for x in mesh.split("x"))
    specs = T.cache_specs(cfg, seq_sharded)
    rep = kv_rep(cfg, tp)
    out = {}
    for name, leaves in specs.items():
        out[name] = {}
        for k, (dp_dim, tp_dim) in leaves.items():
            rows = [np.concatenate([ranks[i * tp + m][f"{tag}:{name}.{k}"]
                                    for m in range(tp)], axis=tp_dim)
                    for i in range(n_dp)]
            full = rows[0] if dp_dim is None else \
                np.concatenate(rows, axis=dp_dim)
            if k in ("k", "v") and rep > 1:
                full = full[:, :, :, ::rep]
            out[name][k] = full
    return out


def _assert_caches(got, want, tol) -> float:
    """Every cache leaf of ``got`` against ``want``; the max abs error."""
    assert sorted(got) == sorted(want)
    worst = 0.0
    for name in want:
        for leaf, w in want[name].items():
            g = got[name][leaf]
            assert g.shape == w.shape, (name, leaf, g.shape, w.shape)
            np.testing.assert_allclose(g, w, err_msg=f"{name}.{leaf}", **tol)
            worst = max(worst, float(np.abs(g - w).max()))
    return worst


def check_case(ref, ranks, cfg, mesh: str, seq_sharded: bool, tol: dict
               ) -> tuple:
    """Hold every rank's prefill logits (its dp rows, every vocab shard
    joined), the joined caches, and each decode step's logits and the
    final caches to ``ref`` at ``tol``, up to the first phase where a MoE
    token routes differently on the two sides; returns the rerouted
    counts of each phase (prefill first) and the max abs error held."""
    n_dp, tp = (int(x) for x in mesh.split("x"))
    vp = cfg.padded_vocab(tp)

    def rows(r, logits):
        if seq_sharded or n_dp == 1:
            return logits
        per = logits.shape[0] // n_dp
        i = r // tp
        return logits[i * per:(i + 1) * per]

    def rerouted(phase):
        want = ref[f"routes_{phase}"]
        if want is None:
            return 0
        return sum(int((want != r[f"routes_{phase}"]).any(-1).sum())
                   for r in ranks)
    counts, worst = [], 0.0
    phases = ([] if seq_sharded else ["prefill"]) + \
        [f"s{i}" for i in range(len(ref["positions"]))]
    for phase in phases:
        counts.append(rerouted(phase))
        if any(counts):        # held up to the first rerouted token
            return counts, worst
        for r, got in enumerate(ranks):
            want = rows(r, np.asarray(ref[phase]))
            assert got[phase].shape == want.shape == \
                (want.shape[0], vp), (phase, got[phase].shape)
            np.testing.assert_allclose(got[phase], want,
                                       err_msg=f"{phase} rank {r}", **tol)
            worst = max(worst, float(np.abs(got[phase] - want).max()))
        if phase == "prefill":
            worst = max(worst, _assert_caches(
                join_caches(ranks, cfg, mesh, "c", seq_sharded),
                ref["caches"], tol))
    worst = max(worst, _assert_caches(
        join_caches(ranks, cfg, mesh, "f", seq_sharded), ref["final"], tol))
    return counts, worst


def write_inputs(workdir, name: str, case: dict, ref: dict, params_file: str
                 ) -> dict:
    """``inputs_<name>.npz`` from ``ref``'s inputs; the case's entry of
    the cases file."""
    arrays = {f"pre:{k}": v for k, v in ref["pre"].items()}
    for i, st in enumerate(ref["steps"]):
        arrays.update({f"s{i}:{k}": v for k, v in st.items()})
    ifile = f"inputs_{name}.npz"
    np.savez(os.path.join(workdir, ifile), **arrays)
    return dict(arch=case["arch"] + "-smoke", mesh=case["mesh"],
                params=params_file, inputs=ifile, batch=ref["batch"],
                prompt=ref["prompt"], cache_len=ref["cache_len"],
                positions=ref["positions"], seq_sharded=case["seq_sharded"])


def write_case(workdir, world: int, cases: dict) -> None:
    with open(os.path.join(workdir, f"cases{world}.json"), "w") as f:
        json.dump(cases, f)


def _leaves(caches, tag: str) -> dict:
    return {f"{tag}:{n}.{k}": t.float().cpu().clone().numpy()
            for n, leaves in caches.items() for k, t in leaves.items()}


def serve_main(rank: int, world: int, workdir: str, backend: str = "gloo"
               ) -> None:
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.convert import shard_params
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.models import transformer as T
    from repro_torch.train.step import make_serve_step
    dev = _init(rank, world, workdir, backend, f"tpserve{world}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    routes = []
    moe = T.moe_forward

    def spy(p, x, cfg, *a, **kw):
        logits = x.reshape(-1, x.shape[-1]).float() @ p["router"].float()
        routes.append(torch.topk(torch.softmax(logits, -1), cfg.moe_top_k,
                                 -1)[1].cpu().numpy())
        return moe(p, x, cfg, *a, **kw)
    T.moe_forward = spy

    def take(tag: str, out: dict) -> None:
        if routes:
            out[f"routes_{tag}"] = np.stack(routes)
        routes.clear()
    try:
        with open(os.path.join(workdir, f"cases{world}.json")) as f:
            cases = json.load(f)
        meshes = {}
        for name, case in cases.items():
            cfg = dataclasses.replace(get_config(case["arch"]),
                                      **case.get("fields", {}))
            if case["mesh"] not in meshes:
                meshes[case["mesh"]] = build_mesh(case["mesh"])
            mesh = meshes[case["mesh"]]
            data = np.load(os.path.join(workdir, case["params"]))
            glob = {k: torch.from_numpy(data[k]) for k in data.files}
            params = {k: v.contiguous().to(dev) for k, v in shard_params(
                glob, T.param_specs(cfg), mesh.tp, mesh.model_rank).items()}
            inp = np.load(os.path.join(workdir, case["inputs"]))
            pre = {k[4:]: torch.from_numpy(inp[k]) for k in inp.files
                   if k.startswith("pre:")}
            b, s_c = case["batch"], case["cache_len"]
            dstep = make_serve_step(cfg, mesh, InputShape(
                "d", s_c, b, "decode"), device=dev.type)
            assert dstep.seq_sharded == case["seq_sharded"]
            out = {}
            if case["seq_sharded"]:
                caches = dstep.init_caches(dtype=torch.float32)
            else:
                pstep = make_serve_step(cfg, mesh, InputShape(
                    "p", case["prompt"], b, "prefill"), device=dev.type)
                out["prefill"] = pstep(params, pre).float().cpu().numpy()
                routes.clear()
                per = b // mesh.n_dp
                mine = {k: v[mesh.dp_rank * per:(mesh.dp_rank + 1) * per]
                        .to(dev) for k, v in pre.items()}
                with torch.inference_mode():
                    _, caches = T.prefill(params, mine, cfg, cache_len=s_c,
                                          ctx=mesh.parallel_ctx())
                take("prefill", out)
                want = dstep.init_caches(dtype=torch.float32)
                for n, leaves in want.items():
                    for k, t in leaves.items():
                        assert caches[n][k].shape == t.shape, (n, k)
                out.update(_leaves(caches, "c"))
            for i, pos in enumerate(case["positions"]):
                step_in = {k[len(f"s{i}:"):]: torch.from_numpy(inp[k])
                           for k in inp.files if k.startswith(f"s{i}:")}
                logits, caches = dstep(params, step_in, caches, pos)
                out[f"s{i}"] = logits.float().cpu().numpy()
                take(f"s{i}", out)
            out.update(_leaves(caches, "f"))
            np.savez(os.path.join(workdir, f"{name}_r{rank}.npz"), **out)
    finally:
        T.moe_forward = moe
        dist.destroy_process_group()


# leaves the reference reads in f32 whatever the compute dtype (the
# engine's rule)
_KEEP_F32 = ("norm1", "norm2", "norm_f", "router", "A_log", "D", "dt_bias")


def rank_params(cfg, tp: int, rank: int, seed: int, dev) -> dict:
    """Model rank ``rank``'s shards of one global model at ``tp``, drawn on
    ``dev`` one superblock slice of each leaf at a time (the global tree
    of a full-size model would not fit one card), each slice with
    ``transformer.init_params``' distribution, the f32 leaves kept f32
    and the rest cast to the compute dtype.  Every rank draws every slice
    from one generator, so the shards are those of one model."""
    from repro_torch.convert import shard_leaf
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.compute_dtype)
    specs, local = T.param_specs(cfg), dict(T.leaf_shapes(cfg, tp))
    out = {}
    for path, shape in T.global_leaf_shapes(cfg, tp):
        dt = torch.float32 if path.rsplit(".", 1)[-1] in _KEEP_F32 else dtype
        dim = specs[path]
        if path.startswith("blocks."):
            t = torch.empty(local[path], dtype=dt, device=dev)
            for i in range(shape[0]):
                piece = T._draw(cfg, path, (1,) + shape[1:], tp, gen)
                t[i].copy_(shard_leaf(piece, dim, tp, rank)[0])
                del piece
        else:
            t = shard_leaf(T._draw(cfg, path, shape, tp, gen), dim, tp,
                           rank).to(device=dev, dtype=dt).contiguous()
        out[path] = t
    return out


def _busy(prof) -> dict:
    """Device busy ms (the union of the kernels' intervals), the kernel
    count and the top kernels by device ms, of one torch.profiler trace."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    iv = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, end = 0.0, None
    for a, b in iv:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"busy_ms": busy / 1e3, "n_kernels": len(evs),
            "top_kernels_ms": [[n[:80], ms] for n, ms in top]}


def path_s_main(rank: int, world: int, workdir: str, backend="nccl"
                ) -> None:
    """Path S (see module doc) on ``world`` = 4 NCCL ranks (gloo: the same
    steps on the CPU, for a cut ``path_s.json``)."""
    import dataclasses
    import time
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.common import gather_model
    from repro_torch.train.step import make_serve_step
    dev = _init(rank, world, workdir, backend, "paths")
    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(workdir, "path_s.json")) as f:
        spec = json.load(f)
    out = {"rank": rank}
    try:
        mesh = build_mesh(spec["mesh"])
        ctx, tp = mesh.parallel_ctx(), mesh.tp
        base = get_config(spec["arch"])

        def sync():
            if on_card:
                torch.cuda.synchronize()
            dist.barrier()
        # --- the cut model in f32: tp against rank 0's tp = 1 -------------
        par = spec["parity"]
        pcfg = dataclasses.replace(base, n_layers=par["layers"],
                                   compute_dtype="float32",
                                   attn_impl="pallas")
        pre, steps = make_inputs(pcfg, par["seed"], par["batch"],
                                 par["prompt"], par["steps"])
        plan = case_plan(pcfg, False, par["batch"], par["prompt"],
                         par["steps"])
        t0 = time.perf_counter()
        params = rank_params(pcfg, tp, mesh.model_rank, par["seed"], dev)
        toks = {k: torch.from_numpy(v).to(dev) for k, v in pre.items()}
        with torch.inference_mode():
            logits, caches = T.prefill(params, toks, pcfg,
                                       cache_len=plan["cache_len"], ctx=ctx)
            got = [gather_model(logits, ctx).float().cpu().numpy()]
            for pos, st in zip(plan["positions"], steps):
                logits, caches = T.decode_step(
                    params, {k: torch.from_numpy(v).to(dev)
                             for k, v in st.items()}, caches, pos, pcfg,
                    ctx=ctx)
                got.append(gather_model(logits, ctx).float().cpu().numpy())
        del params, caches
        torch.cuda.empty_cache()
        sync()
        if rank == 0:
            one = rank_params(pcfg, 1, 0, par["seed"], dev)
            ref = port_reference(pcfg, one, pre, steps, plan, dev)
            want = [ref["prefill"]] + [ref[f"s{i}"]
                                       for i in range(par["steps"])]
            out["parity"] = [
                {"max_abs_err": float(np.abs(a - b).max()),
                 "max_abs_logit": float(np.abs(b).max())}
                for a, b in zip(got, want)]
            del one
            torch.cuda.empty_cache()
        out["parity_s"] = time.perf_counter() - t0
        sync()
        # --- path S: the full model in bf16 -------------------------------
        cfg = dataclasses.replace(base, attn_impl="pallas")
        b, s, n_new = spec["batch"], spec["prompt"], spec["new_tokens"]
        t0 = time.perf_counter()
        params = rank_params(cfg, tp, mesh.model_rank, spec["seed"], dev)
        sync()
        out["draw_s"] = time.perf_counter() - t0
        out["rank_param_bytes"] = sum(t.numel() * t.element_size()
                                      for t in params.values())
        gen = torch.Generator().manual_seed(spec["seed"])
        prompts = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                dtype=torch.int32)
        pstep = make_serve_step(cfg, mesh, InputShape("p", s, b, "prefill"),
                                device=dev.type)
        dstep = make_serve_step(cfg, mesh, InputShape("d", s + n_new, b,
                                                      "decode"),
                                device=dev.type)
        pstep(params, {"tokens": prompts})          # warm-up
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        logits = pstep(params, {"tokens": prompts})
        sync()
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        out["prefill_launches"] = build.launch_counts()
        out["prefill_finite"] = bool(torch.isfinite(logits).all())
        with torch.inference_mode():
            _, caches = T.prefill(params, {"tokens": prompts.to(dev)}, cfg,
                                  cache_len=s + n_new, ctx=ctx)
        tok = logits[:, :cfg.vocab].argmax(-1, keepdim=True).to(torch.int32)
        sync()
        tokens, dec_ms = [tok.cpu()], []
        for i in range(n_new - 1):
            t1 = time.perf_counter()
            logits, caches = dstep(params, {"tokens": tok}, caches, s + i)
            tok = logits[:, :cfg.vocab].argmax(-1, keepdim=True).to(
                torch.int32)
            sync()
            dec_ms.append((time.perf_counter() - t1) * 1e3)
            tokens.append(tok.cpu())
        out["decode_ms"] = dec_ms
        out["peak_bytes"] = torch.cuda.max_memory_allocated() \
            if on_card else None
        out["tokens"] = torch.cat(tokens, 1).tolist()
        # one profiled decode step (every rank runs it; each profiles)
        sync()
        acts = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            t1 = time.perf_counter()
            logits, caches = dstep(params, {"tokens": tok}, caches,
                                   s + n_new - 1)
            sync()
            wall = (time.perf_counter() - t1) * 1e3
        prof_out = _busy(prof)
        prof_out["wall_ms"] = wall
        prof_out["idle_share"] = 1.0 - prof_out["busy_ms"] / wall \
            if on_card else None
        out["profile"] = prof_out
        with open(os.path.join(workdir, f"path_s_r{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
