"""The port's profile fold (``repro_torch.obs.profile``) and the launcher's
``--profile`` / ``--drift-probe`` / ``--memory`` over gloo.

  * ``parse_scope`` / ``cell_key``, the interval algebra,
    ``overlap_audit``, ``audit_diff`` and ``attribution`` give the
    reference's results on the same names, intervals and folds.
  * ``fold_trace`` on a hand-built Kineto trace: each kernel joined
    through its ``args.correlation`` to its ``cuda_runtime`` launch and
    the innermost ``obs::`` range around that launch on the launch's
    thread; the NCCL kernel lands on its collective's cell as wire, the
    rest as compute; unmatched kernels stay in the residual; attributed +
    residual == the ``profile.window`` range.  A CPU trace folds its
    ``cpu_op`` events, each op once within its range (an op issued from
    inside an op that began outside the range, as a backward hook's
    collective, counts).  A window with no device event raises,
    also when the trace holds host events only (the second-profiler
    hazard: a CUDA trace that read no device time is not folded as an
    empty one).
  * ``run`` on 2 spawned gloo ranks (a ``file://`` rendezvous under
    ``tmp_path``) of ``bert-base-smoke`` with 2 buckets and backward
    overlap: with ``telemetry``, ``memory``, ``profile`` and
    ``drift_probe`` on, every rank's ``profile`` event has a cell for
    every (bucket, stage) op of ``pipe(flat/onebit)x2`` (and one for the
    metrics' all-reduce) and
    ``t_attributed + t_residual == t_window``; the drift events validate
    (``probe_plan`` over the 2 ranks fed the monitor); the histories and
    state are bitwise the run with everything off, and the
    ``torch.distributed`` calls of the steps are the same (the probe's
    own calls, before the first step, aside); with ``audit`` on the
    histories and state are bitwise too.
"""
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.obs import events as JE  # noqa: E402
from repro.obs import profile as JP  # noqa: E402
from repro_torch.obs import events as PE  # noqa: E402
from repro_torch.obs import profile as PP  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_obs_worker as ow  # noqa: E402

NAMES = [
    "obs::flat/onebit::s0::AllToAll~intra",
    "obs::pipe(flat/onebit)x2::b1.s1::AllGather~intra",
    "obs::hier/onebit+outer_ef::b12.s3::AllGather~cross",
    "prefix obs::allreduce::s0::AllReduce@cross suffix",
    "aten::add", "profile.window", "obs::broken::sX::AllToAll~intra",
]


@pytest.mark.parametrize("name", NAMES)
def test_parse_scope_is_the_reference(name):
    got, want = PP.parse_scope(name), JP.parse_scope(name)
    assert got == want
    if got is not None:
        assert PP.cell_key(got) == JP.cell_key(want)


SPANS = [[(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)], [(2.0, 2.0), (1.0, 0.5)],
         [(0.0, 10.0)], []]


@pytest.mark.parametrize("a", range(len(SPANS)))
@pytest.mark.parametrize("b", range(len(SPANS)))
def test_interval_algebra_is_the_reference(a, b):
    ma, mb = PP.merge_spans(SPANS[a]), PP.merge_spans(SPANS[b])
    assert ma == JP.merge_spans(SPANS[a])
    assert PP.span_length(ma) == JP.span_length(ma)
    assert PP.intersect_spans(ma, mb) == JP.intersect_spans(ma, mb)
    assert PP.clip_spans(ma, 0.25, 3.5) == JP.clip_spans(ma, 0.25, 3.5)


def _iv(stream, t0, t1, bucket=0, stage=0):
    return {"stream": stream, "t_start": t0, "t_end": t1, "bucket": bucket,
            "stage": stage, "phase": "wire" if stream != "compute"
            else "compute"}


INTERVALS = [
    [_iv("compute", 0.0, 1.0), _iv("intra", 0.5, 2.0),
     _iv("cross", 1.5, 3.0, 1), _iv("bwd", 0.0, 0.7)],
    [_iv("compute", 0.0, 1.0)],
    [],
]


@pytest.mark.parametrize("case", range(len(INTERVALS)))
def test_overlap_audit_and_diff_are_the_reference(case):
    got = PP.overlap_audit(INTERVALS[case])
    assert got == JP.overlap_audit(INTERVALS[case])
    pred = PP.overlap_audit(INTERVALS[0])
    assert PP.audit_diff(got, pred) == JP.audit_diff(got, pred)


def _launch(name, ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": 2, "pid": 7, "tid": tid, "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}


def _ann(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 7, "tid": tid}


S0 = "obs::pipe(flat/onebit)x2::b0.s0::AllToAll~intra"
S1 = "obs::pipe(flat/onebit)x2::b1.s0::AllToAll~intra"


def _trace():
    """A hand-built Kineto window of 100 us: bucket 0's range holds the
    compress kernel and the NCCL all_to_all, bucket 1's range (nested in
    an unrelated outer range) one decompress; one matmul outside any
    range; a launch on another thread inside no range."""
    return [
        _ann("profile.window", 0, 100),
        _ann(S0, 10, 30),
        _launch("cudaLaunchKernel", 12, 1),
        _launch("cudaLaunchKernel", 20, 2),
        _ann("some.outer.range", 40, 40),
        _ann(S1, 45, 10),
        _launch("cudaLaunchKernel", 47, 3),
        _launch("cudaLaunchKernel", 60, 4),
        _launch("cudaLaunchKernel", 15, 5, tid=2),
        _kernel("ef_compress_kernel", 14, 6, 1),
        _kernel("ncclDevKernel_AllToAll_RING", 22, 20, 2),
        _kernel("decompress_kernel", 50, 4, 3),
        _kernel("ampere_sgemm_128x64", 62, 10, 4),
        _kernel("elementwise_kernel", 80, 5, 5),
        _kernel("orphan_kernel", 90, 3, 99),
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 13,
         "dur": 1, "pid": 7, "tid": 1},
    ]


def test_fold_joins_kernels_through_their_launch():
    fold = PP.fold_trace(_trace(), device="cuda")
    assert fold["window"] == pytest.approx((0.0, 100e-6))
    cells = fold["cells"]
    c0 = cells[("pipe(flat/onebit)x2", 0, 0, "AllToAll", "intra")]
    c1 = cells[("pipe(flat/onebit)x2", 1, 0, "AllToAll", "intra")]
    assert (c0["n"], c1["n"]) == (2, 1)
    assert c0["t_wire"] == pytest.approx(20e-6)
    assert c0["t_compute"] == pytest.approx(6e-6)
    assert (c1["t_wire"], c1["t_compute"]) == (0.0, pytest.approx(4e-6))
    assert len(cells) == 2
    assert (fold["n_events"], fold["n_matched"], fold["n_unattributed"]) \
        == (6, 3, 3)
    # ef_compress [14, 20] and NCCL [22, 42] and decompress [50, 54]
    assert fold["t_attributed"] == pytest.approx(30e-6)
    assert fold["t_attributed"] + fold["t_residual"] == fold["t_window"]
    streams = {iv["stream"] for iv in fold["intervals"]}
    assert streams == {"intra", "compute"}
    fields = PP.attribution(fold, n_steps=2, bytes_per_step=8.0,
                            source="test")
    assert fields == JP.attribution(fold, n_steps=2, bytes_per_step=8.0,
                                    source="test")
    assert fields["comm_fraction"] == pytest.approx(0.2)
    PE.make_event("profile", **fields)
    JE.make_event("profile", **fields)


def _op(name, ts, dur):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur,
            "pid": 7, "tid": 1}


def test_fold_of_a_cpu_trace_counts_each_range_once():
    ev = [_ann("profile.window", 0, 100), _ann(S0, 5, 20),
          _op("c10d::alltoall_base_", 6, 8),
          _op("aten::empty", 7, 1),             # nested, same range: no
          _op("aten::mul", 16, 4),
          _op("aten::mm", 30, 10),              # outside every range
          # a backward op that began outside bucket 1's range, which a
          # hook opens inside it: the collective under the range counts
          _op("autograd::engine::evaluate_function: MmBackward0", 50, 40),
          _ann(S1, 60, 20),
          _op("c10d::alltoall_base_", 62, 6),
          _op("aten::copy_", 63, 1)]            # nested, same range: no
    fold = PP.fold_trace(ev, device="cpu")
    c0 = fold["cells"][("pipe(flat/onebit)x2", 0, 0, "AllToAll", "intra")]
    c1 = fold["cells"][("pipe(flat/onebit)x2", 1, 0, "AllToAll", "intra")]
    assert (c0["n"], c0["t_wire"], c0["t_compute"]) == \
        (2, pytest.approx(8e-6), pytest.approx(4e-6))
    assert (c1["n"], c1["t_wire"], c1["t_compute"]) == \
        (1, pytest.approx(6e-6), 0.0)
    assert (fold["n_events"], fold["n_matched"]) == (5, 3)
    assert fold["t_attributed"] == pytest.approx(18e-6)
    assert fold["t_attributed"] + fold["t_residual"] == \
        pytest.approx(100e-6)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_a_window_without_device_events_raises(device):
    host_only = [e for e in _trace() if e["cat"] in
                 ("user_annotation", "cuda_runtime")]
    with pytest.raises(ValueError, match="nothing to fold"):
        PP.fold_trace(host_only, device=device)
    late = [_ann("profile.window", 0, 10),
            _launch("cudaLaunchKernel", 2, 1),
            _kernel("k", 500, 5, 1),
            {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 400,
             "dur": 4, "pid": 7, "tid": 1}]
    with pytest.raises(ValueError, match="nothing to fold"):
        PP.fold_trace(late, device=device)       # all outside the window
    with pytest.raises(ValueError, match="device must be"):
        PP.fold_trace(_trace(), device="tpu")


def test_fold_profile_reads_an_exported_trace(tmp_path):
    path = tmp_path / "trace_rank0.json"
    path.write_text(json.dumps({"traceEvents": _trace()}))
    assert PP.fold_profile(str(path))["cells"] == \
        PP.fold_trace(_trace())["cells"]


SMALL = dict(arch="bert-base-smoke", steps=5, warmup_steps=2, batch=4,
             seq=16, block_size=512, lr=2e-3, lr_warmup=2, pipeline="2",
             overlap_bwd="on")


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    import torch.multiprocessing as mp
    workdir = str(tmp_path_factory.mktemp("obs_runs"))
    runs = {"off": SMALL,
            "obs": dict(SMALL, telemetry=os.path.join(workdir, "tel"),
                        memory="on", profile=os.path.join(workdir, "prof"),
                        profile_steps=2, drift_probe=True, bench="gloo"),
            "audit": dict(SMALL, audit="on", audit_every=1)}
    with open(os.path.join(workdir, "runs.json"), "w") as f:
        json.dump(runs, f)
    mp.start_processes(ow.runs_main, args=(2, workdir), nprocs=2,
                       start_method="spawn")
    out = []
    for r in range(2):
        with open(os.path.join(workdir, f"runs{r}.json")) as f:
            out.append(json.load(f))
    return workdir, out


def test_gloo_profile_attributes_every_bucket_stage(gloo_runs):
    from repro_torch.obs.bench import load_ledger
    workdir, out = gloo_runs
    want = {("pipe(flat/onebit)x2", b, s, k, "intra")
            for b in (0, 1) for s, k in enumerate(("AllToAll",
                                                   "AllGather"))}
    for rank, res in enumerate(out):
        with open(res["obs"]["telemetry"]) as f:
            recs = [json.loads(ln) for ln in f]
        assert JE.validate_records(recs) == len(recs)
        [prof] = [r for r in recs if r["type"] == "profile"]
        cells = {(c["plan"], c["bucket"], c["stage"], c["kind"], c["tier"])
                 for c in prof["cells"]}
        # the metrics' dp mean runs the all-reduce plan: a cell of its own
        assert cells == want | {("allreduce", None, 0, "AllReduce",
                                 "intra")}, rank
        assert all(c["n"] > 0 for c in prof["cells"])
        assert prof["t_attributed"] > 0
        assert prof["t_attributed"] + prof["t_residual"] == \
            pytest.approx(prof["t_window"], rel=1e-12)
        assert [r["bucket"] for r in prof["ready_order"]] == [0, 1]
        drift = [r for r in recs if r["type"] == "drift"]
        assert {(r["op_kind"], r["tier"]) for r in drift} == {
            ("AllToAll", "intra"), ("AllGather", "intra")}
        assert all(r["n_samples"] == 3 for r in drift)
        kinds = {r["kind"] for r in recs if r["type"] == "memory"}
        assert kinds == {"predicted", "live"}
        assert res["obs"]["profile"]
    ledger = load_ledger(os.path.join(workdir, "prof", "BENCH_gloo.json"))
    [rec] = ledger["records"]
    assert rec["mesh"] == [2] and rec["pipeline"] == 2
    assert rec["metrics"]["n_cells"] == 5.0
    assert "mem_state_bytes" in rec["metrics"]


def test_gloo_observability_is_neutral(gloo_runs):
    _, out = gloo_runs
    for rank, res in enumerate(out):
        off, obs, aud = res["off"], res["obs"], res["audit"]
        assert obs["history"] == off["history"], rank
        assert aud["history"] == off["history"], rank
        assert obs["state"] == off["state"] == aud["state"], rank
        # the drift probe's calls come first; the steps' are the same
        n_probe = len(obs["calls"]) - len(off["calls"])
        assert n_probe > 0
        assert obs["calls"][n_probe:] == off["calls"], rank
        assert off["calls"], rank
