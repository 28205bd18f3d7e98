"""The port's telemetry layer (``repro_torch.obs``) against the JAX package's
(``repro.obs``) on the same records and numbers.

  * Schema: every minimal record of the reference's ``TestEventSchema``
    validates under both packages, both reject the same malformed records
    with the same message, and the schema tables are equal; a port log of
    a ``bert-base-smoke`` CPU run passes ``repro.obs.events
    .validate_records``, and ``repro.obs.report.summarize`` and the port's
    ``summarize`` give equal summaries of it.
  * Sinks and ``MetricBuffer`` (one ``torch.cat`` a fetch).
  * Spans: ``span_name`` letter for letter the reference's; op scopes a
    shared ``nullcontext`` when off; on a 2 x 2 gloo mesh (spawned, a
    ``file://`` rendezvous under ``tmp_path``) the ``obs::`` range names
    the port records under ``torch.profiler`` for the flat plan, the
    hierarchical plan and a 2-bucket pipelined plan are the reference's
    ``scoped_op_names`` of the same plans, and the ``torch.distributed``
    calls (``benchmarks.comm_volume.ByteCounter``) and results are the
    same with tracing on and off.
  * Step spans and counters: every step span a shared ``nullcontext``
    and the counters at zero when off; on, a CPU profile of one
    ``bert-base-smoke`` step holds each span, ``model.block`` once a
    superblock in the forward and again inside backward under recompute;
    the counters send the plan IR's ``wire_send_bytes`` for each kind;
    over the 2 x 2 gloo ranks a warmup and a compressed ``train_step``
    leave state and calls bitwise as with tracing off, and the compressed
    step's dp counters hold its plan's ``wire_send_bytes`` and a call a
    payload leaf of each op, plus the metrics' all-reduce.
  * Drift: the same samples give the reference's report, drifting pairs,
    fit and recalibration JSON; ``probe_plan`` over the 2 x 2 ranks feeds
    the monitor (intra and cross samples) and its events validate.
  * Neutrality: ``run`` on the CPU with telemetry, audit, memory and
    profile on gives the histories and state of the run with all off,
    bitwise (the step walls aside).
  * End to end: the CLI's ``--telemetry`` log validates, its
    ``--log-file`` holds every step, and ``python -m
    repro_torch.obs.report`` prints a log and diffs two.
  * Benchmarks: ``comm_fraction`` and ``throughput_scaling`` equal the
    reference's results and their BENCH records are keyed alike;
    ``variance_stability``'s events validate under both packages.
"""
import contextlib
import importlib
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.obs import drift as JD  # noqa: E402
from repro.obs import events as JE  # noqa: E402
from repro.obs import report as JR  # noqa: E402
from repro.obs import trace as JT  # noqa: E402
from repro.pipeline.executor import \
    scoped_op_names as jpipe_names  # noqa: E402
from repro.plan.executor import scoped_op_names as jplan_names  # noqa: E402
from repro_torch.obs import drift as PD  # noqa: E402
from repro_torch.obs import events as PE  # noqa: E402
from repro_torch.obs import metrics as PM  # noqa: E402
from repro_torch.obs import report as PR  # noqa: E402
from repro_torch.obs import trace as PT  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, os.path.dirname(__file__))
import _torch_obs_worker as ow  # noqa: E402

MINIMAL = {
    "run_meta": dict(optimizer="onebit_adam", compressor="onebit",
                     topology="flat", n_buckets=1),
    "plan": dict(name="flat_onebit", stage="compressed", d=4096,
                 intra_hlo_bytes=1e6, cross_hlo_bytes=0.0),
    "comm": dict(t_comm=0.5, t_compute=0.2),
    "step": dict(step=3),
    "transition": dict(step=7, kind="stage", to="compressed"),
    "warning": dict(what="non-finite v_l1"),
    "span": dict(name="train.window", dur=0.25),
    "drift": dict(op_kind="AllReduce", tier="intra", n_samples=4,
                  t_measured=1e-3, t_predicted=2e-3, ratio=0.5,
                  drifting=True),
    "recalibration": dict(op_overhead=5e-6),
    "profile": dict(n_steps=4, t_window=1.0, t_attributed=0.8,
                    t_residual=0.2),
    "fidelity": dict(step=4, n_segments=3),
    "health": dict(step=4, ok=True),
    "memory": dict(kind="live", step=4, bytes_in_use=1e6),
}

REJECTED = [
    ("transition", dict(step=1, kind="stage")),          # no "to"
    ("step", dict(step="three")),
    ("step", dict(step=1, loss="diverged")),
    ("comm", dict(t_comm=True, t_compute=0.1)),          # bool != num
    ("metrics", dict(step=1)),                           # unknown type
    ("step", dict(step=1, custom=[1, 2])),               # extras scalar
    ("memory", dict(total_bytes=1.0)),                   # kind required
    ("memory", dict(kind="predicted", categories=["params", 1.0])),
    ("fidelity", dict(step=1)),                          # n_segments
    ("health", dict(step=1, ok=True, verdicts="loss_spike")),
]

SMALL = dict(arch="bert-base-smoke", steps=5, warmup_steps=2, batch=2,
             seq=16, block_size=512, lr=2e-3, lr_warmup=2, device="cpu",
             verbose=False)


@pytest.mark.parametrize("etype", sorted(MINIMAL))
def test_minimal_record_validates_under_both(etype):
    for E in (PE, JE):
        rec = E.make_event(etype, **MINIMAL[etype])
        assert rec["type"] == etype and "t" in rec
        assert E.validate_event(rec) is rec
        # a record of one package validates under the other
        other = JE if E is PE else PE
        assert other.validate_event(dict(rec)) == rec


@pytest.mark.parametrize("case", range(len(REJECTED)))
def test_rejections_agree(case):
    etype, fields = REJECTED[case]
    msgs = []
    for E in (PE, JE):
        with pytest.raises(ValueError) as err:
            E.make_event(etype, **fields)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_schema_tables_equal_the_reference():
    assert PE.EVENT_SCHEMA == JE.EVENT_SCHEMA
    for name in ("STEP_METRICS", "HEALTH_VERDICTS", "MEMORY_KINDS",
                 "TRANSITION_KINDS", "BENCH_SCHEMA", "BENCH_KEY_FIELDS"):
        assert getattr(PE, name) == getattr(JE, name), name
    good = PE.make_event("step", step=0)
    assert PE.validate_records([good, good]) == 2
    for E in (PE, JE):
        with pytest.raises(ValueError, match="record 1:"):
            E.validate_records([good, {"type": "step"}])


def test_sinks(tmp_path):
    assert not PM.as_sink(None).enabled
    with PM.as_sink(str(tmp_path), buffer_lines=2) as sink:
        assert sink.enabled
        for s in range(3):
            sink.emit("step", step=s, loss=1.0)
        with pytest.raises(ValueError, match="expected num"):
            sink.emit("step", step=9, loss="x")
    lines = (tmp_path / "telemetry.jsonl").read_text().splitlines()
    assert [json.loads(ln)["step"] for ln in lines] == [0, 1, 2]
    assert JE.validate_records(json.loads(ln) for ln in lines) == 3


def test_metric_buffer_fetches_with_one_cat(monkeypatch):
    cats = []
    real = torch.cat

    def counted(*a, **kw):
        cats.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(torch, "cat", counted)
    buf = PM.MetricBuffer()
    for s in range(4):
        buf.push(s, {"loss": torch.tensor(2.0 - s),
                     "seg": torch.arange(3.0) + s})
    assert buf.n_pending == 4
    rec = buf.host(2)
    assert rec == {"loss": 0.0, "seg": [2.0, 3.0, 4.0]}
    assert buf.host(2) is rec and len(cats) == 1
    drained = buf.drain()
    assert len(cats) == 2                         # the other three at once
    assert [s for s, _ in drained] == [0, 1, 2, 3]
    assert drained[1][1] == {"loss": 1.0, "seg": [1.0, 2.0, 3.0]}
    assert buf.n_pending == 0 and buf.drain() == []


@pytest.mark.parametrize("bucket", [None, 0, 3])
@pytest.mark.parametrize("plan,stage,kind,tier", [
    ("flat/onebit", 0, "AllToAll", "intra"),
    ("hier/onebit", 2, "AllGather", "cross"),
    ("pipe(flat/onebit)x4", 1, "AllGather", "intra"),
    ("allreduce", 0, "AllReduce", "cross")])
def test_span_name_is_the_reference(plan, stage, kind, tier, bucket):
    assert PT.span_name(plan, stage, kind, tier, bucket) == \
        JT.span_name(plan, stage, kind, tier, bucket)


def test_op_scope_disabled_is_shared_nullcontext_and_enabled_a_range():
    class Op:
        kind, tier = "AllToAll", "intra"
    assert not PT.tracing_enabled()
    a, b = PT.op_scope("p", 0, Op()), PT.op_scope("p", 1, Op(), 2)
    assert a is b and isinstance(a, contextlib.nullcontext)
    with PT.tracing(True):
        scope = PT.op_scope("p", 1, Op(), 2)
        assert isinstance(scope, torch.profiler.record_function)
        assert scope.name == "obs::p::b2.s1::AllToAll~intra"
    assert not PT.tracing_enabled()


def test_step_spans_and_counters_are_off_by_default():
    assert not PT.tracing_enabled()
    assert PT.scope(PT.FORWARD_SPAN) is PT.op_scope("p", 0, None)
    assert all(PT.scope(s) is PT.scope(PT.FORWARD_SPAN)
               for s in PT.STEP_SPANS)
    PT.reset_counters()
    PT.count_collective("all_reduce", torch.zeros(8), ("dp",), 2)
    assert PT.counters() == {}
    with PT.tracing(True):
        assert PT.scope(PT.BLOCK_SPAN).name == PT.BLOCK_SPAN
        PT.count_collective("all_reduce", torch.zeros(8), ("dp",), 2)
    assert PT.counters() == {"dp": {"all-reduce": {"calls": 1,
                                                   "bytes": 32.0}}}
    PT.reset_counters()
    assert PT.counters() == {}


@pytest.mark.parametrize("fn,op", [
    ("all_to_all_single", "AllToAll"), ("all_gather_into_tensor",
                                        "AllGather"),
    ("all_reduce", "AllReduce"), ("reduce_scatter_tensor",
                                  "ReduceScatter")])
def test_counters_send_the_plans_wire_bytes(fn, op):
    from repro_torch.plan import ir
    ws = (ir.WireSpec("uint8", (512,)), ir.WireSpec("float32", (8,)))
    want = getattr(ir, op)(axes=("dp",), n=4, tier="intra", payload=ws,
                           d_in=4096)
    PT.reset_counters()
    with PT.tracing(True):
        for w in ws:
            PT.count_collective(fn, torch.zeros(w.shape,
                                                dtype=getattr(torch, w.dtype)),
                                ("dp",), want.n)
    got = PT.counters()["dp"][PT.COLLECTIVE_KINDS[fn]]
    PT.reset_counters()
    assert got == {"calls": 2, "bytes": pytest.approx(want.wire_send_bytes)}


@pytest.mark.parametrize("remat", [True, False])
def test_step_spans_under_the_profiler(tmp_path, remat):
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import SyntheticStream
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import get_optimizer
    from repro_torch.train.step import init_train_state, train_step
    cfg = dataclasses.replace(get_config("bert-base-smoke"), remat=remat)
    opt = get_optimizer("onebit_adam", compressor="onebit",
                        compressor_kwargs={"block_size": 256})
    ts = init_train_state(cfg, init_params(
        cfg, torch.Generator().manual_seed(0)), opt, 256)
    batch = SyntheticStream(cfg, InputShape("t", 16, 2, "train"),
                            seed=0).batch_at(0)
    train_step(ts, opt, batch, 1e-3, "warmup")
    with PT.tracing(True), profile(activities=[ProfilerActivity.CPU]) as p:
        train_step(ts, opt, batch, 1e-3, "compressed")
    path = str(tmp_path / "trace.json")
    p.export_chrome_trace(path)
    with open(path) as f:
        ranges = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    names = [e["name"] for e in ranges]
    assert set(PT.STEP_SPANS) <= set(names)
    bwd = [(e["ts"], e["ts"] + e["dur"]) for e in ranges
           if e["name"] == PT.BACKWARD_SPAN]
    blocks = [any(a <= e["ts"] <= b for a, b in bwd) for e in ranges
              if e["name"] == PT.BLOCK_SPAN]
    n = len(ts.model.superblocks())
    assert blocks.count(False) == n
    assert blocks.count(True) == (n if remat else 0)


def test_tracer_records_emits_and_closes_on_raise(tmp_path):
    with PM.as_sink(str(tmp_path)) as sink:
        tr = PT.Tracer(sink)
        with tr.span("outer", step=1):
            with tr.span("inner", n=2):
                pass
        with pytest.raises(RuntimeError):
            with tr.span("boom"):
                raise RuntimeError("x")
    recs = [json.loads(ln) for ln in
            (tmp_path / "telemetry.jsonl").read_text().splitlines()]
    JE.validate_records(recs)
    assert [r["name"] for r in recs if r["type"] == "span"] == \
        ["inner", "outer", "boom"]
    assert [s["depth"] for s in tr.spans] == [1, 0, 0]
    assert tr.spans[-1]["ok"] is False
    assert recs[-1]["type"] == "warning" and recs[-1]["what"] == "span.abort"


@pytest.fixture(scope="module")
def spans(tmp_path_factory):
    import torch.multiprocessing as mp
    workdir = str(tmp_path_factory.mktemp("spans"))
    mp.start_processes(ow.spans_main, args=(4, workdir), nprocs=4,
                       start_method="spawn")
    out = []
    for r in range(4):
        with open(os.path.join(workdir, f"spans{r}.json")) as f:
            out.append(json.load(f))
    return out


def _reference_plans():
    from repro.optim import get_compressor
    from repro.pipeline import Bucketer, lower_to_pipelined
    from repro.plan import schedules as S
    comp = get_compressor("onebit", block_size=ow.BLOCK)
    flat = S.flat_schedule(comp, ow.D, 4, ("pod", "data"))
    return {"flat": jplan_names(flat),
            "hier": jplan_names(S.hier_schedule(
                comp, ow.D, 2, 2, ("data",), ("pod",), outer_ef=False)),
            "pipe2": jpipe_names(lower_to_pipelined(
                flat, comp, Bucketer.for_exchange(ow.D, 4, ow.BLOCK, 2)))}


@pytest.mark.parametrize("key", ["flat", "hier", "pipe2"])
def test_recorded_ranges_are_the_reference_names(spans, key):
    want = sorted(set(_reference_plans()[key]))
    for rank, out in enumerate(spans):
        assert out[key]["names"] == want, rank


@pytest.mark.parametrize("key", ["flat", "hier", "pipe2"])
def test_tracing_leaves_calls_and_results_unchanged(spans, key):
    for rank, out in enumerate(spans):
        assert out[key]["calls_on"] == out[key]["calls_off"], rank
        assert out[key]["calls_on"], rank        # real collectives ran
        assert out[key]["bitwise"], rank


def test_step_spans_leave_the_step_and_its_calls_unchanged(spans):
    for rank, out in enumerate(spans):
        st = out["step"]
        assert st["calls_on"] == st["calls_off"] and st["calls_on"], rank
        assert st["bitwise"], rank
        assert st["counters_off"] == {}, rank


def test_step_counters_are_the_plans_wire_bytes(spans):
    from repro_torch.optim import get_compressor
    from repro_torch.plan import AllReduce, WireSpec, flat_schedule
    comp = get_compressor("onebit", block_size=ow.BLOCK)
    for rank, out in enumerate(spans):
        st = out["step"]
        plan = flat_schedule(comp, st["d_pad"], 4, ("pod", "data"))
        metrics = AllReduce(axes=("pod", "data"), n=4, tier="intra",
                            payload=(WireSpec("float32",
                                              (st["n_metrics"],)),),
                            d_in=st["n_metrics"])
        assert list(st["counters_on"]) == ["pod+data"], rank
        dp = st["counters_on"]["pod+data"].values()
        assert sum(c["bytes"] for c in dp) == pytest.approx(
            plan.wire_send_bytes() + metrics.wire_send_bytes), rank
        # one call a payload leaf (the signs, the scales) of each op
        assert sum(c["calls"] for c in dp) == \
            sum(len(op.payload) for op in plan.ops) + 1, rank


def test_probe_plan_feeds_the_monitor_over_gloo(spans):
    from repro_torch.plan import get_cluster
    for out in spans:
        samples = [PD.DriftSample(**s) for s in out["probe"]]
        assert {(s.op_kind, s.tier) for s in samples} == {
            ("AllToAll", "intra"), ("AllToAll", "cross"),
            ("AllGather", "cross"), ("AllGather", "intra")}
        assert all(s.seconds > 0 and s.n == 2 for s in samples)
        mon = PD.DriftMonitor(get_cluster("ethernet-10g", 2, 2))
        for s in samples:
            mon.observe(s.op_kind, s.tier, s.n, s.payload_bytes, s.seconds)
        for etype, fields in mon.events():
            PE.make_event(etype, **fields)
            JE.make_event(etype, **fields)
        assert len(mon.report()) == 4


def test_probe_plan_of_one_rank_is_empty():
    from repro_torch.optim import get_compressor
    from repro_torch.plan import flat_schedule
    comp = get_compressor("onebit", block_size=64)
    assert PD.probe_plan(flat_schedule(comp, 256, 1, ()), "cpu") == []


TRUTH = ("truth", (50e-6, 1.25e9), (500e-6, 0.125e9), 8, 4, 5e-6)
WRONG = ("wrong", (5e-6, 200e9), (5e-6, 25e9), 8, 4, 1e-6)


def _spec(mod, name, intra, cross, n_inner, n_outer, overhead):
    return mod.ClusterSpec(name=name, intra=mod.LinkSpec(*intra),
                           cross=mod.LinkSpec(*cross), n_inner=n_inner,
                           n_outer=n_outer, op_overhead=overhead)


def _samples():
    from repro.plan import cost as JC
    truth = _spec(JC, *TRUTH)
    out = []
    for kind in ("AllToAll", "AllGather", "AllReduce", "ReduceScatter"):
        for tier, n in (("intra", 8), ("cross", 4)):
            for mb in (1, 4, 16):
                p = mb * 2 ** 20
                out.append((kind, tier, n, p,
                            JC.op_time_kind(kind, tier, n, p, truth)))
    return out


@pytest.mark.parametrize("against", [TRUTH, WRONG])
@pytest.mark.parametrize("threshold", [0.1, 0.25])
def test_drift_monitor_matches_reference(tmp_path, against, threshold):
    from repro.plan import cost as JC
    from repro_torch.plan import cost as PC
    mons = (PD.DriftMonitor(_spec(PC, *against), threshold=threshold),
            JD.DriftMonitor(_spec(JC, *against), threshold=threshold))
    for s in _samples():
        got = [m.observe(*s) for m in mons]
        assert got[0] == pytest.approx(got[1], rel=1e-12)
    got, want = mons[0].report(), mons[1].report()
    assert [(r["op_kind"], r["tier"], r["drifting"], r["n_samples"])
            for r in got] == [(r["op_kind"], r["tier"], r["drifting"],
                               r["n_samples"]) for r in want]
    for a, b in zip(got, want):
        assert a["ratio"] == pytest.approx(b["ratio"], rel=1e-12)
    assert mons[0].drifting == mons[1].drifting
    assert bool(mons[0].drifting) == (against is WRONG)
    if against is WRONG:
        pa, pb = str(tmp_path / "a.json"), str(tmp_path / "b.json")
        ra, rb = mons[0].emit_recalibration(pa), \
            mons[1].emit_recalibration(pb)
        for k in ("op_overhead", "n_inner", "n_outer"):
            assert ra[k] == pytest.approx(rb[k], rel=1e-9), k
        for tier in ("intra", "cross"):
            for f in ("latency", "bandwidth"):
                assert ra[tier][f] == pytest.approx(rb[tier][f],
                                                    rel=1e-6), (tier, f)
        spec = PC.ClusterSpec.from_measured(pa)
        for kind, tier, n, p, secs in _samples():
            assert PC.op_time_kind(kind, tier, n, p, spec) == \
                pytest.approx(secs, rel=1e-3)
        evs = mons[0].events(emit_recal_path=pa)
        assert [t for t, _ in evs].count("recalibration") == 1
        for etype, fields in evs:
            JE.make_event(etype, **fields)


def _strip(h):
    return [{k: v for k, v in r.items() if k != "ms"} for r in h]


@pytest.mark.parametrize("pipeline", ["off", "2"])
def test_observability_leaves_the_run_bitwise(tmp_path, pipeline):
    from repro_torch.launch.train import run
    kw = dict(SMALL, pipeline=pipeline,
              overlap_bwd="on" if pipeline != "off" else "off")
    off = run(**kw)
    on = run(**kw, telemetry=str(tmp_path / "tel"),
             profile=str(tmp_path / "prof"), profile_steps=2, memory="on",
             audit="on", audit_every=1)
    assert off["telemetry"] is None and off["profile"] is None
    assert _strip(on["history"]) == _strip(off["history"])
    assert all("ms" in h for h in on["history"])     # log_every=1
    assert torch.equal(on["state"].x, off["state"].x)
    for k in off["state"].opt:
        assert torch.equal(on["state"].opt[k], off["state"].opt[k]), k
    recs = JR.load(on["telemetry"], validate=True)
    types = [r["type"] for r in recs]
    assert types.count("step") == SMALL["steps"]
    assert types.count("fidelity") == SMALL["steps"] - SMALL["warmup_steps"]
    assert types.count("profile") == 1
    assert {r["kind"] for r in recs if r["type"] == "memory"} == \
        {"predicted", "live"}        # the CPU has no allocator reading


def test_log_every_windows_the_records(tmp_path):
    from repro_torch.launch.train import run
    one = run(**SMALL)
    res = run(**SMALL, log_every=4, telemetry=str(tmp_path))   # 0, 4
    assert _strip(res["history"]) == _strip(one["history"])
    assert not any("ms" in h for h in res["history"])
    recs = PR.load(res["telemetry"], validate=True)
    wins = [r for r in recs if r["type"] == "span"
            and r["name"] == "train.window"]
    assert [w["n"] for w in wins] == [1, 4]            # steps 0 and 4
    assert [r["step"] for r in recs if r["type"] == "step"] == \
        list(range(SMALL["steps"]))


def test_cli_log_validates_and_report_prints(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    logs = []
    hist = str(tmp_path / "history.json")
    for i, extra in enumerate((["--log-file", hist],
                               ["--audit", "on", "--audit-every", "2"])):
        tel = str(tmp_path / f"tel{i}")
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--device",
             "cpu", "--arch", "bert-base-smoke", "--steps", "5",
             "--warmup-steps", "2", "--batch", "2", "--seq", "16",
             "--block-size", "512", "--log-every", "2", "--telemetry", tel,
             "--memory", "on"] + extra,
            env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "telemetry: " in proc.stdout
        logs.append(os.path.join(tel, "telemetry.jsonl"))
    with open(hist) as f:
        assert [h["step"] for h in json.load(f)] == list(range(5))
    recs = PR.load(logs[1])
    assert JE.validate_records(recs) == len(recs)
    assert PR.summarize(recs) == JR.summarize(recs)
    for args, want in (([logs[1], "--validate"], "compression-fidelity"),
                       (logs, "== diff:")):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.report"] + list(args),
            env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert want in proc.stdout


def _reference_benchmark(name):
    if ROOT not in sys.path:
        sys.path.insert(0, os.path.abspath(ROOT))
    return importlib.import_module(f"benchmarks.{name}")


def _keyed(payload):
    return {JE.bench_key(r): r["metrics"] for r in payload["records"]}


def test_comm_fraction_equals_reference(tmp_path):
    from repro_torch.benchmarks import comm_fraction as CF
    from repro_torch.obs.bench import load_ledger
    ref = _reference_benchmark("comm_fraction")
    got = CF.run(verbose=False, telemetry=str(tmp_path / "tel"),
                 ledger=str(tmp_path / "p.json"))
    want = ref.run(verbose=False, ledger=str(tmp_path / "r.json"))
    assert got == want
    assert _keyed(load_ledger(str(tmp_path / "p.json"))) == \
        _keyed(load_ledger(str(tmp_path / "r.json")))
    recs = PR.load(str(tmp_path / "tel" / "comm_fraction.jsonl"))
    assert JE.validate_records(recs) == 2 * len(got)


def test_throughput_scaling_equals_reference(tmp_path):
    from repro_torch.benchmarks import throughput_scaling as TS
    from repro_torch.obs.bench import load_ledger
    ref = _reference_benchmark("throughput_scaling")
    got = TS.run(verbose=False, ledger=str(tmp_path / "p.json"))
    want = ref.run(verbose=False, ledger=str(tmp_path / "r.json"))
    assert got == want
    assert _keyed(load_ledger(str(tmp_path / "p.json"))) == \
        _keyed(load_ledger(str(tmp_path / "r.json")))


def test_variance_stability_events_validate(tmp_path):
    from repro_torch.benchmarks import variance_stability as VS
    with PM.as_sink(str(tmp_path), filename="vs.jsonl") as sink:
        quad = VS.quadratic_phase(segments=4, steps=120, sink=sink)
        sys_ = VS.system_phase(steps=4, lr_warmup=2, sink=sink)
    recs = PR.load(str(tmp_path / "vs.jsonl"))
    assert JE.validate_records(recs) == len(recs)
    types = [r["type"] for r in recs]
    assert types.count("fidelity") == 120
    assert types.count("step") == 124
    fid = [r for r in recs if r["type"] == "fidelity"]
    assert all(len(r["v_l1_seg"]) == 4 for r in fid)
    assert "v_drift" in fid[-1] and "v_drift" not in fid[0]
    if quad["freeze_step"] is not None:
        assert types.count("transition") >= 1
    rec = VS.ledger_record(quad, sys_, 4)
    JE.validate_bench_record(rec)
    assert rec["metrics"]["fidelity_n_segments"] == 4.0
