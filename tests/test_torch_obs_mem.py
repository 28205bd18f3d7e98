"""The port's memory ledger (``repro_torch.obs.mem``) against the JAX
package's (``repro.obs.mem``).

  * ``predict_ledger``: every category equal to the reference's, in bytes,
    on the same configuration, mesh shape, optimizer, layout and topology
    (with the compressed plan and a cluster of the same links and device
    numbers, so the pipelined wire watermark is priced on the same
    timeline), at smoke size and at full BERT-Large (the zero1 pin that
    PERF.md's open memory reading is priced with).
  * The wire watermark: the reference's ``TestWireWatermark`` cases on the
    port's ``wire_watermark`` and ``wire_ledger_bytes`` (peak, not sum;
    the bwd-overlap schedule; the fallback when ``ready`` has the wrong
    length).
  * Attribution: ``attributed + residual == total`` on hand-built readings
    and the reference's numbers for each; the measured reader
    (``StepMemory``) gives None on the CPU; the event fields validate.
  * ``LiveSampler``, ``mem_metrics``, ``format_rows`` and the report's
    memory section, summary for summary the reference's.
"""
import json
import types

import pytest

torch = pytest.importorskip("torch")

from repro.obs import events as JE  # noqa: E402
from repro.obs import mem as JM  # noqa: E402
from repro.obs import report as JR  # noqa: E402
from repro_torch.obs import events as PE  # noqa: E402
from repro_torch.obs import mem as PM  # noqa: E402
from repro_torch.obs import report as PR  # noqa: E402

DEV = dict(peak_flops=3.0e14, hbm_bw=1.5e12, kernel_overhead=8e-6)

PINS = (("onebit_adam", "replicated", "flat"),
        ("onebit_adam", "replicated", "hier"),
        ("onebit_adam", "zero1", "flat"),
        ("onebit_lamb", "replicated", "flat"),
        ("zerone_adam", "local", "flat"))


def _jmesh(sizes):
    axes = ("data", "model") if len(sizes) == 1 else ("pod", "data", "model")
    return types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, tuple(sizes) + (1,))))


def _both(arch, sizes, optname, layout, topology, n_buckets, block,
          batch, seq, ready=None):
    """(port ledger, reference ledger) of the same run."""
    import math

    from repro.configs import get_config as jcfg
    from repro.optim import get_optimizer as jopt
    from repro.perf.device import DeviceSpec as JDev
    from repro.plan import cost as JC
    from repro.plan import schedules as JS
    from repro_torch.configs import get_config as pcfg
    from repro_torch.optim import get_optimizer as popt
    from repro_torch.perf.device import DeviceSpec as PDev
    from repro_torch.plan import cost as PC
    from repro_torch.plan import schedules as PS
    from repro_torch.train.step import flat_dim
    n = math.prod(sizes)
    n_inner, n_outer = (sizes[-1], sizes[0]) if len(sizes) > 1 else (n, 1)
    d = flat_dim(pcfg(arch), n, block)
    out = []
    for cfg, opt, sched, cost, dev, mesh, mod in (
            (pcfg(arch), popt, PS, PC, PDev("d", **DEV, backend="cpu"),
             tuple(sizes), PM),
            (jcfg(arch), jopt, JS, JC, JDev("d", **DEV), _jmesh(sizes), JM)):
        o = opt(optname, compressor="onebit",
                compressor_kwargs={"block_size": block})
        if topology == "hier" and n_outer > 1:
            axes = ("data",), ("pod",)
            plan = sched.hier_schedule(o.compressor, d, n_inner, n_outer,
                                       *axes, outer_ef=False)
        else:
            plan = sched.flat_schedule(o.compressor, d, n,
                                       ("pod", "data")[-len(sizes):])
        spec = cost.get_cluster("ethernet-10g", n_inner, n_outer,
                                device=dev)
        out.append(mod.predict_ledger(
            cfg, mesh, optim=o, layout=layout, topology=topology,
            block=block, n_buckets=n_buckets, batch_global=batch, seq=seq,
            plan=plan, spec=spec, ready=ready))
    return out


@pytest.mark.parametrize("sizes", [(1,), (4,), (2, 2)])
@pytest.mark.parametrize("pin", PINS)
@pytest.mark.parametrize("n_buckets", [1, 3])
def test_predict_ledger_equals_reference(sizes, pin, n_buckets):
    got, want = _both("bert-base-smoke", sizes, *pin, n_buckets=n_buckets,
                      block=512, batch=8, seq=64)
    assert tuple(got.categories) == PM.MEM_CATEGORIES == JM.MEM_CATEGORIES
    assert dict(got.categories) == dict(want.categories)
    assert got.total_bytes == want.total_bytes
    assert got.categories["opt_state"] > 0


@pytest.mark.parametrize("layout", ["replicated", "zero1"])
def test_full_bert_large_ledger_equals_reference(layout):
    got, want = _both("bert-large", (1,), "onebit_adam", layout, "flat",
                      n_buckets=1, block=4096, batch=16, seq=128)
    assert dict(got.categories) == dict(want.categories)
    # d_pad = 364,564,480: four f32 vectors and the EF slots replicated
    assert got.categories["grads"] == 4 * 364_564_480


def test_wire_row_under_overlap_and_its_fallback():
    ready = [3e-4, 2e-4, 1e-4, 0.0]
    got, want = _both("bert-base-smoke", (4,), "onebit_adam", "replicated",
                      "flat", n_buckets=4, block=512, batch=8, seq=64,
                      ready=ready)
    assert got.categories["wire"] == want.categories["wire"] > 0
    assert "bwd-overlap" in got.detail["wire"]
    from repro_torch.optim import get_compressor
    from repro_torch.plan import flat_schedule, get_cluster
    comp = get_compressor("onebit", block_size=512)
    plan = flat_schedule(comp, 8192, 4, ("dp",))
    spec = get_cluster("ethernet-10g", 4, device="cpu-host")
    base, _ = PM.wire_ledger_bytes(plan, comp, 4, 4, 512, spec)
    wrong, _ = PM.wire_ledger_bytes(plan, comp, 4, 4, 512, spec,
                                    ready=[1.0, 2.0])   # wrong length
    assert wrong == base <= PM.staging_bytes_serial(plan) * 4
    assert PM.wire_ledger_bytes(None)[0] == 0.0


def _iv(bucket, t0, t1, phase="wire"):
    return {"bucket": bucket, "stage": 0, "phase": phase, "stream": "intra",
            "kind": "allreduce", "tier": "intra", "t_start": t0,
            "t_end": t1}


@pytest.mark.parametrize("ivs,want", [
    ([], 150.0),                                       # falls back: sum
    ([_iv(0, 0.0, 1.0), _iv(1, 2.0, 3.0)], 100.0),     # disjoint: max
    ([_iv(0, 0.0, 2.0), _iv(1, 1.0, 3.0)], 160.0),     # overlapping: stack
    ([_iv(0, 0.0, 1.0), _iv(1, 1.0, 2.0)], 100.0),     # back to back
    ([_iv(0, 0.0, 1.0), _iv(0, 2.5, 3.0), _iv(1, 2.0, 4.0)], 160.0),
    ([_iv(0, 0.0, 2.0), _iv(1, 1.0, 3.0),
      dict(_iv(1, 0.0, 3.0, "bwd"), stream="bwd")], 160.0)])
def test_wire_watermark_cases(ivs, want):
    from repro.plan.cost import wire_watermark as jwm
    from repro_torch.plan import wire_watermark
    assert wire_watermark(ivs, [100.0, 50.0 if not ivs else 60.0]) == want
    assert jwm(ivs, [100.0, 50.0 if not ivs else 60.0]) == want


def _ledgers(**cats):
    base = {"params": 100.0, "grads": 50.0, "opt_state": 300.0,
            "wire": 10.0, "activations": 40.0}
    base.update(cats)
    return PM.MemoryLedger(categories=base), JM.MemoryLedger(categories=base)


@pytest.mark.parametrize("arg,out,tmp,alias,metrics", [
    (1000, 450, 250, 0, 8.0), (0, 100, 0, 0, 0.0), (10, 7, 5, 3, 4096.0),
    (5, 1_000_000, 2_000_000, 0, 4096.0), (0, 0, 0, 0, 4096.0)])
def test_attribution_identity_and_reference(arg, out, tmp, alias, metrics):
    pl, jl = _ledgers()
    pcm = PM.CompiledMemory("compressed", arg, out, tmp, alias)
    jcm = JM.CompiledMemory("compressed", arg, out, tmp, alias)
    got = PM.attribute_compiled(pl, pcm, metrics_bytes=metrics)
    assert got == JM.attribute_compiled(jl, jcm, metrics_bytes=metrics)
    assert got["attributed_bytes"] + got["residual_bytes"] == float(out +
                                                                    tmp)
    assert pcm.per_device_bytes == jcm.per_device_bytes
    fields = PM.attribution_event_fields(pl, pcm, metrics_bytes=metrics)
    want = dict(JM.attribution_event_fields(jl, jcm, metrics_bytes=metrics),
                source="repro_torch.obs.mem")
    assert fields == want
    PE.make_event("memory", **fields)
    JE.make_event("memory", **fields)


def test_step_memory_is_none_on_the_cpu():
    with PM.StepMemory("warmup", "cpu") as sm:
        torch.ones(1024).sum()
    assert sm.memory is None
    assert PM.MEMORY_MODES == JM.MEMORY_MODES


def test_live_sampler_fields_validate():
    sampler = PM.LiveSampler("cpu")
    fields = sampler.sample(step=3)
    assert fields is not None, "no live source on this host (psutil)"
    assert fields["device"] == "host-rss" and fields["step"] == 3
    assert fields["peak_bytes_in_use"] >= fields["bytes_in_use"] > 0
    assert sampler.peak_bytes == fields["peak_bytes_in_use"]
    PE.make_event("memory", **fields)
    JE.make_event("memory", **fields)


def test_mem_metrics_and_rows_match_reference():
    pl, jl = _ledgers()
    pcm = PM.CompiledMemory("compressed", 40, 35, 10, 0)
    jcm = JM.CompiledMemory("compressed", 40, 35, 10, 0)
    assert PM.mem_metrics(pl, pcm, 61.0) == JM.mem_metrics(jl, jcm, 61.0)
    assert PM.mem_metrics(pl) == JM.mem_metrics(jl)
    cap = PM.MemoryLedger(categories=dict(pl.categories),
                          capacity_bytes=2.0 ** 34)
    text = PM.format_rows(cap, [PM.attribute_compiled(cap, pcm)])
    for name in PM.MEM_CATEGORIES:
        assert name in text
    assert "capacity" in text and "measured [compressed]" in text
    assert cap.event_fields()["state_bytes_per_rank"] == 300.0


def test_report_memory_section_equals_reference(tmp_path):
    led = PM.MemoryLedger(
        categories={"params": 10.0, "grads": 5.0, "opt_state": 30.0,
                    "wire": 2.0, "activations": 3.0},
        capacity_bytes=100.0)
    cm = PM.CompiledMemory("compressed", 40, 35, 10, 0)
    records = [PE.make_event("memory", **led.event_fields()),
               PE.make_event("memory",
                             **PM.attribution_event_fields(led, cm)),
               PE.make_event("memory", kind="live", step=0,
                             bytes_in_use=60.0, peak_bytes_in_use=61.0,
                             device="cuda", source="repro_torch.obs.mem")]
    path = tmp_path / "tel.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in records) + "\n")
    recs = PR.load(str(path), validate=True)
    summ = PR.summarize(recs)
    assert summ == JR.summarize(JR.load(str(path), validate=True))
    assert summ["memory"]["predicted"]["total_bytes"] == 50.0
    assert summ["memory"]["compiled"][0]["program"] == "compressed"
    assert summ["memory"]["live"]["peak_bytes"] == 61.0
    text = PR.format_report(summ)
    assert text == JR.format_report(summ)
    assert "memory ledger" in text and "opt_state" in text
    rows = {r["metric"] for r in PR._diff_rows(summ, summ)}
    assert {"mem.predicted.total_bytes", "mem.compressed.temp_bytes",
            "mem.live.peak_bytes"} <= rows
