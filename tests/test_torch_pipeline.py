"""The port's bucketed pipeline (``repro_torch.pipeline``) against the JAX
package's (``repro.pipeline``).

  * ``Bucketer``: sizes and offsets equal the reference's over a grid of
    (d, n_total, block, n_buckets), clamping included; an unaligned d is
    refused; ``state.bucket_sizes_for`` is the same partition.
  * ``lower_to_pipelined``: op for op the reference's lowering of the
    same flat and hierarchical plans (names, sizes, offsets, kinds,
    tiers, EF slots, ``d_in``, payloads, the per-op compute annotations),
    its ``slot_strides``,
    ``issue_order`` with and without ``order``, byte totals; a payload
    that is not linear is refused.
  * A single rank's pipelined exchange is bitwise its serial one and is
    held to the reference's ``compressed_exchange(n_buckets=NB)`` at
    ``tests/test_torch_exchange.py``'s tolerances (1-bit: rtol 1e-5 /
    atol 1e-6, the block means sum in another order than XLA's; top-k
    and identity bitwise), for NB in 1, 2, 4, 7.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import comm as jcomm  # noqa: E402
from repro.optim import get_compressor as jget_compressor  # noqa: E402
from repro.pipeline import Bucketer as JBucketer  # noqa: E402
from repro.pipeline import lower_to_pipelined as jlower  # noqa: E402
from repro.plan import schedules as jsched  # noqa: E402
from repro_torch.core import comm as tcomm  # noqa: E402
from repro_torch.optim.compressors import get_compressor  # noqa: E402
from repro_torch.pipeline import (Bucketer, Wavefront,  # noqa: E402
                                  execute_pipelined, lower_to_pipelined)
from repro_torch.plan import schedules as tsched  # noqa: E402
from repro_torch.plan.ir import AllGather, CommPlan, WireSpec  # noqa: E402
from repro_torch.state import bucket_sizes_for  # noqa: E402

GRID = [(d_units * n * b, n, b, nb)
        for d_units in (1, 3, 7, 16)
        for n in (1, 2, 4)
        for b in (8, 64, 512)
        for nb in (1, 2, 3, 4, 7, 20)]


@pytest.mark.parametrize("d_units", [1, 3, 7, 16])
def test_bucketer_matches_reference(d_units):
    for d, n, b, nb in GRID:
        if d != d_units * n * b:
            continue
        got = Bucketer.for_exchange(d, n, b, nb)
        want = JBucketer.for_exchange(d, n, b, nb)
        assert (got.sizes, got.offsets, got.align) == \
            (want.sizes, want.offsets, want.align), (d, n, b, nb)
        assert got.n_buckets == min(nb, d_units)
        assert bucket_sizes_for(d, n, b, nb) == got.sizes


def test_bucketer_refuses_unaligned():
    with pytest.raises(ValueError):
        Bucketer.for_exchange(3 * 64 + 8, 1, 64, 2)
    with pytest.raises(ValueError):
        Bucketer.build(64, 0, 64)
    with pytest.raises(AssertionError):          # the reference agrees
        JBucketer.for_exchange(3 * 64 + 8, 1, 64, 2)


def _ws(specs):
    return tuple((w.dtype, tuple(w.shape)) for w in specs)


def _ops(plan):
    return [(op.kind, op.tier, op.err_slot, op.d_in, op.n, tuple(op.axes),
             _ws(op.payload)) for op in plan.ops]


def _plans(topo, kind, d, block):
    tc = get_compressor(kind, block_size=block)
    jc = jget_compressor(kind, block_size=block)
    if topo == "flat":
        return (tsched.flat_schedule(tc, d, 4, ("dp",)),
                jsched.flat_schedule(jc, d, 4, ("dp",)), tc, jc)
    ef = tsched.needs_outer_ef(tc)
    assert ef == jsched.needs_outer_ef(jc)
    return (tsched.hier_schedule(tc, d, 2, 2, ("data",), ("pod",), ef),
            jsched.hier_schedule(jc, d, 2, 2, ("data",), ("pod",), ef),
            tc, jc)


@pytest.mark.parametrize("topo", ["flat", "hier"])
@pytest.mark.parametrize("kind", ["onebit", "topk", "identity"])
@pytest.mark.parametrize("nb", [1, 3, 4])
def test_lowering_matches_reference(topo, kind, nb):
    block = 64
    d = 7 * 4 * block
    tplan, jplan, tc, jc = _plans(topo, kind, d, block)
    assert tplan.name == jplan.name and _ops(tplan) == _ops(jplan)
    assert tplan.hlo_bytes() == jplan.hlo_bytes()
    assert tplan.wire_send_bytes("cross") == jplan.wire_send_bytes("cross")
    tp = lower_to_pipelined(tplan, tc, Bucketer.for_exchange(d, 4, block,
                                                             nb))
    jp = jlower(jplan, jc, JBucketer.for_exchange(d, 4, block, nb))
    assert (tp.name, tp.d, tp.n_buckets, tp.n_stages, tp.streams,
            tp.err_slots) == (jp.name, jp.d, jp.n_buckets, jp.n_stages,
                              jp.streams, jp.err_slots)
    for a, b in zip(tp.buckets, jp.buckets):
        assert (a.index, a.offset, a.size, a.plan.name, a.plan.d) == \
            (b.index, b.offset, b.size, b.plan.name, b.plan.d)
        assert _ops(a.plan) == _ops(b.plan)
        # the (pre, post) ComputeSpecs each op is priced with
        assert [(p.flops, p.hbm_bytes, p.kernels, q.flops, q.hbm_bytes,
                 q.kernels) for p, q in a.compute] == \
            [(p.flops, p.hbm_bytes, p.kernels, q.flops, q.hbm_bytes,
              q.kernels) for p, q in b.compute]
    assert tp.slot_strides() == jp.slot_strides()
    assert tp.slot_lengths() == jp.slot_lengths()
    assert list(tp.edges()) == list(jp.edges())
    order = tuple(reversed(range(tp.n_buckets)))
    assert list(tp.issue_order()) == list(jp.issue_order())
    assert list(tp.issue_order(order)) == list(jp.issue_order(order))
    assert tp.hlo_bytes() == jp.hlo_bytes() == tplan.hlo_bytes()
    assert tp.wire_send_bytes() == jp.wire_send_bytes()
    assert tp.describe().splitlines()[0] == jp.describe().splitlines()[0]


def test_lowering_refuses_nonlinear_payload():
    comp = get_compressor("onebit", block_size=64)
    op = AllGather(axes=("dp",), n=2, tier="intra",
                   payload=(WireSpec("uint8", (3,)),), d_in=256)
    plan = CommPlan(name="odd", d=256, ops=(op,)).validate()
    with pytest.raises(ValueError, match="neither"):
        lower_to_pipelined(plan, comp, Bucketer.for_exchange(256, 2, 64, 2))
    with pytest.raises(ValueError):
        next(lower_to_pipelined(
            tsched.flat_schedule(comp, 256, 1, ()), comp,
            Bucketer.for_exchange(256, 1, 64, 2)).issue_order((0, 0)))


BLOCK = 64
D = 7 * 3 * BLOCK


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(D).astype(np.float32)
    werr = (rng.standard_normal(D) * 0.1).astype(np.float32)
    serr = (rng.standard_normal(D) * 0.1).astype(np.float32)
    return x, werr, serr


@pytest.mark.parametrize("kind", ["onebit", "topk", "identity"])
@pytest.mark.parametrize("nb", [1, 2, 4, 7])
def test_single_rank_pipelined(kind, nb):
    x, werr, serr = _inputs(nb)
    tc = get_compressor(kind, block_size=BLOCK)
    errs = {"worker": torch.from_numpy(werr), "server": torch.from_numpy(serr)}
    ser, ser_errs = tcomm.compressed_exchange(torch.from_numpy(x), errs, (),
                                              (), tc)
    got, got_errs = tcomm.compressed_exchange(torch.from_numpy(x), errs, (),
                                              (), tc, n_buckets=nb)
    assert torch.equal(got, ser)
    for k in ("worker", "server"):
        assert torch.equal(got_errs[k], ser_errs[k]), k
    jout, jerrs = jcomm.compressed_exchange(
        jnp.asarray(x), {"worker": jnp.asarray(werr),
                         "server": jnp.asarray(serr)}, (), (),
        jget_compressor(kind, block_size=BLOCK), n_buckets=nb)
    pairs = [(got, jout)] + [(got_errs[k], jerrs[k])
                             for k in ("worker", "server")]
    for a, b in pairs:
        if kind == "onebit":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_parts_and_fed_wavefront_are_bitwise_serial():
    """Parts in reversed order, and a wavefront fed one bucket at a time
    with every stage 0 first (backward overlap's order), are the serial
    exchange."""
    x, werr, serr = _inputs(3)
    tc = get_compressor("onebit", block_size=BLOCK)
    errs = {"worker": torch.from_numpy(werr), "server": torch.from_numpy(serr)}
    xt = torch.from_numpy(x)
    ser, ser_errs = tcomm.compressed_exchange(xt, errs, (), (), tc)
    plan, n_total = tcomm.exchange_plan(D, errs, (), (), tc)
    pplan = lower_to_pipelined(plan, tc, Bucketer.for_exchange(D, 1, BLOCK,
                                                               4))
    parts = tuple(xt[bp.offset:bp.offset + bp.size] for bp in pplan.buckets)
    got, got_errs = execute_pipelined(pplan, tc, parts, errs)
    assert torch.equal(got, ser)
    wf = tcomm.start_exchange(D, errs, (), (), tc, 4)
    assert wf.order == (3, 2, 1, 0) and wf.stage0_first
    for b in (1, 3, 0, 2):            # fed out of order, issued in order
        wf.feed(b, parts[b])
        wf.issue_ready()
    assert wf.issued == {(b, 0) for b in range(4)}
    got2, errs2 = wf.finish()
    assert torch.equal(got2, ser)
    for k in ("worker", "server"):
        assert torch.equal(got_errs[k], ser_errs[k])
        assert torch.equal(errs2[k], ser_errs[k])
    with pytest.raises(RuntimeError):
        w = Wavefront(pplan, tc, errs)
        w.finish()
    assert tcomm.start_exchange(D, errs, (), (), tc, 1) is None


def test_exchange_parts_must_match_the_buckets():
    """A tuple of parts goes in only as the buckets (one part of ``d``
    serially); any other split is refused, not concatenated."""
    x, werr, serr = _inputs(4)
    tc = get_compressor("onebit", block_size=BLOCK)
    errs = {"worker": torch.from_numpy(werr), "server": torch.from_numpy(serr)}
    xt = torch.from_numpy(x)
    ser, _ = tcomm.compressed_exchange(xt, errs, (), (), tc)
    one, _ = tcomm.compressed_exchange((xt,), errs, (), (), tc)
    assert torch.equal(one, ser)
    sizes = Bucketer.for_exchange(D, 1, BLOCK, 2).sizes
    two, _ = tcomm.compressed_exchange(
        (xt[:sizes[0]], xt[sizes[0]:]), errs, (), (), tc, n_buckets=2)
    assert torch.equal(two, ser)
    halves = (xt[:BLOCK], xt[BLOCK:])
    for nb in (1, 2):
        with pytest.raises(ValueError):
            tcomm.compressed_exchange(halves, errs, (), (), tc, n_buckets=nb)


@pytest.mark.parametrize("kind", ["onebit", "topk", "identity"])
def test_compressors_write_into_out(kind):
    """``ef_compress(out=)`` and ``decompress(out=)`` into slices of a
    larger tensor are bitwise the calls that allocate, and return the
    slice itself."""
    x, werr, _ = _inputs(5)
    tc = get_compressor(kind, block_size=BLOCK)
    xt, et = torch.from_numpy(x), torch.from_numpy(werr)
    payload, new_err = tc.ef_compress(xt, et)
    big = torch.full((3 * D,), 7.0)
    p2, e2 = tc.ef_compress(xt, et, out=big[D:2 * D])
    dec = tc.decompress(payload, out=big[2 * D:])
    assert e2.data_ptr() == big[D:].data_ptr() and torch.equal(e2, new_err)
    assert all(torch.equal(a, b) for a, b in zip(p2, payload))
    assert dec.data_ptr() == big[2 * D:].data_ptr()
    assert torch.equal(dec, tc.decompress(payload))
    assert torch.equal(big[:D], torch.full((D,), 7.0))


def test_plan_line_names_wire_bytes(capsys):
    """The run prints its plans with the bytes a rank puts on the wire a
    step (the plan IR's ``wire_send_bytes``)."""
    from repro_torch.launch.train import run
    res = run(arch="bert-large-smoke", steps=0, warmup_steps=0, batch=4,
              seq=16, block_size=BLOCK, device="cpu", pipeline=2,
              overlap_bwd="on")
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith("[plan] mesh 1 ('dp',) | warmup ")
    assert f"compressed {res['plan']} | overlap-bwd on | wire bytes a " \
        "rank and step: warmup 0, compressed 0" in line


# --- checkpoints across bucket counts --------------------------------------

CKPT_MESHES = {"flat2": ("2", "flat", (2,)), "hier4": ("2x2x1", "hier", (2, 2))}


def _ckpt_runs(workdir, mesh, topology):
    path = str(workdir / "c.npz")
    base = dict(arch="bert-large-smoke", warmup_steps=3, batch=8, seq=32,
                block_size=512, lr=2e-3, lr_warmup=2, mesh=mesh,
                topology=topology)
    return {"full": dict(base, steps=6, pipeline=4, overlap_bwd="on"),
            "first": dict(base, steps=4, pipeline=4, overlap_bwd="on",
                          ckpt=path),
            "off": dict(base, steps=6, pipeline="off", resume=path),
            "two": dict(base, steps=6, pipeline=2, resume=path)}


@pytest.mark.parametrize("name", sorted(CKPT_MESHES))
def test_checkpoint_resumes_under_other_bucket_counts(tmp_path, name):
    """Saved at step 4 under ``pipeline=4`` (backward overlap on), resumed
    under ``pipeline="off"`` and ``pipeline=2``: steps 4-5 are bitwise the
    uninterrupted ``pipeline=4`` run on every rank, and so are the final
    parameters and every state slot (chunk slots keyed canonically)."""
    import json
    import torch.multiprocessing as mp
    import _torch_hier_worker as worker
    from repro_torch.convert import state_to_global
    from repro_torch.optim import get_optimizer
    from repro_torch.state import StateLayout, to_canonical
    from repro_torch.train.step import segment_info
    from repro_torch.configs import get_config
    mesh, topology, sizes = CKPT_MESHES[name]
    with open(tmp_path / "runs.json", "w") as f:
        json.dump(_ckpt_runs(tmp_path, mesh, topology), f)
    n = int(np.prod(sizes))
    mp.start_processes(worker.run_main, args=(n, str(tmp_path), "gloo"),
                       nprocs=n, start_method="spawn")
    ranks = [np.load(tmp_path / f"run{r}.npz") for r in range(n)]
    want_plan = f"pipe({topology}/onebit)x4"
    assert str(ranks[0]["full__plan"]) == want_plan
    assert list(ranks[0]["full__overlap"]) == [False] * 3 + [True] * 3
    slots = get_optimizer("onebit_adam").state_slots("replicated")
    d_pad = ranks[0]["full__x"].shape[0]
    hier = topology == "hier"
    ctx = StateLayout(d=d_pad, n_dp=n, n_srv=sizes[-1] if hier else n,
                      n_outer=sizes[0] if hier else 1,
                      n_segments=segment_info(get_config("bert-large-smoke"),
                                              d_pad).n,
                      dp_sizes=sizes, tp=1)

    def canon(run, nb):
        states = [{s.name: torch.from_numpy(r[f"{run}__opt_{s.name}"])
                   for s in slots} for r in ranks]
        return to_canonical(state_to_global(states, slots, ctx), slots, ctx,
                            n_buckets=nb, block=512)

    full = canon("full", 4)
    for run, nb in (("off", 1), ("two", 2)):
        for r in ranks:
            np.testing.assert_array_equal(r[f"{run}__loss"],
                                          r["full__loss"][4:])
            np.testing.assert_array_equal(r[f"{run}__x"], r["full__x"])
        got = canon(run, nb)
        for s in slots:
            np.testing.assert_array_equal(got[s.name], full[s.name],
                                          err_msg=f"{run} {s.name}")


@pytest.mark.parametrize("n_dp,n_srv,n_outer", [(2, 2, 1), (4, 2, 2),
                                                (8, 4, 2)])
def test_layout_manifest_matches_reference(n_dp, n_srv, n_outer):
    """The hierarchical contexts' manifests (slot table, per-rank bytes,
    the run->canonical permutation of every bucket count) equal the
    reference's."""
    from repro.optim import get_optimizer as jget_optimizer
    from repro.state import StateLayout as JLayout
    from repro.state import layout_manifest as jmanifest
    from repro.state import ef_element_map as jmap
    from repro_torch.optim import get_optimizer
    from repro_torch.state import StateLayout, ef_element_map, layout_manifest
    d = 6 * n_dp * 64
    dp_sizes = (n_outer, n_srv) if n_outer > 1 else (n_dp,)
    ctx = StateLayout(d=d, n_dp=n_dp, n_srv=n_srv, n_outer=n_outer,
                      n_segments=5, dp_sizes=dp_sizes, tp=1)
    jctx = JLayout(d=d, n_dp=n_dp, n_srv=n_srv, n_outer=n_outer,
                   n_segments=5, dp_sizes=dp_sizes, tp=1)
    slots = get_optimizer("onebit_adam").state_slots("replicated")
    jslots = jget_optimizer("onebit_adam").state_slots("replicated")
    counts = (1, 2, 3, 4, 6)
    assert layout_manifest(slots, ctx, block=64, bucket_counts=counts) == \
        jmanifest(jslots, jctx, block=64, bucket_counts=counts)
    for nb in counts:
        sizes = bucket_sizes_for(d, n_dp, 64, nb)
        for n_sub in (1, n_outer):
            np.testing.assert_array_equal(
                ef_element_map(d, sizes, n_srv, n_sub),
                jmap(d, sizes, n_srv, n_sub))
