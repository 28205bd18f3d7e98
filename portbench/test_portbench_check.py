"""The comparison that decides ``correct``, run through the harness on the
CPU at a small width: the program's run is correct under each cell's own
limits, the control (the reference with its state in bfloat16) and every
fault planted under the program's step are not.  The harness's look for
a card is skipped; everything else of a run is driven.  Also the result
line, the trace fold, and the refusal to run without a card."""
import copy
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

from portbench import check, harness, tracefold  # noqa: E402


def small_cell(name: str) -> dict:
    """The cell with a two-layer, 64-wide model in float32 (each
    configuration's own mechanisms: GQA, MLM or causal LM) and a small
    batch; its limits are the cell's own."""
    cell = copy.deepcopy(harness.load_cell(name))
    causal = cell["config"]["causal"]
    cell["config"].update(n_layers=2, d_model=64, n_heads=4,
                          n_kv_heads=2 if causal else 4, d_ff=128,
                          vocab=512, block_size=256,
                          compute_dtype="float32")
    cell["traffic"].update(batch_per_dp=8, seq=16, pool=5, traced_steps=2,
                           ref_rows=4)
    return cell


def _fails(nums: dict, limits: dict) -> bool:
    return not check.verdict(nums, limits)[0]


@pytest.mark.parametrize("name", ["bert-large.onebit.b128s128",
                                  "bert-large.adam.b128s128"])
def test_one_card_cell_control_and_faults(name):
    cell = small_cell(name)
    job = {"mode": "calibrate", "cell": cell, "device": "cpu",
           "seeds": [2 ** 31 + 11]}
    row = harness.run_job(job)["rows"][0]
    limits = cell["limits"]
    assert check.verdict(row["sound"], limits)[0], row["sound"]
    assert _fails(row["control"], limits), row["control"]
    assert _fails(row["half_batch"], limits), row["half_batch"]
    # a step that leaves the state as it was
    r = harness.Rank(0, 1, job)
    seed = job["seeds"][0]
    nums = r.compare(seed, r.program_readings(seed, "unchanged"))
    assert nums["grad_gap"] == pytest.approx(1.0)
    assert _fails(nums, limits)


def test_result_line_has_the_contract_keys():
    cell = small_cell("bert-large.onebit.b128s128")
    job = {"mode": "bench", "cell": cell, "seed": 2 ** 31 + 3,
           "seconds": 0.2, "trace": False, "device": "cpu"}
    rec = harness.run_job(job)
    out = json.loads(json.dumps(harness.result(cell, job, rec, 0.0)))
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == rec["window_steps"] >= 1
    assert set(out["metrics"]) == {"train_tokens_per_s", "peak_mem_gb",
                                   "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert out["device"]["count"] == 1
    assert set(out["checks"]) == set(check.START + check.SWITCH + check.COMP)


def _ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_fold_parts_busy_gaps_and_launches():
    ev = [_ev("user_annotation", tracefold.WINDOW_RANGE, 0, 100),
          _ev("user_annotation", tracefold.STEP_RANGE, 0, 60),
          _ev("user_annotation", tracefold.BACKWARD_RANGE, 10, 18),
          _ev("cpu_op", "aten::mm", 5, 3),
          _ev("cuda_runtime", "cudaLaunchKernel", 6, 1, corr=1),
          _ev("cuda_runtime", "cudaLaunchKernel", 20, 1, corr=2),
          _ev("cpu_op", "aten::mul", 39, 3),
          _ev("cuda_runtime", "cudaLaunchKernel", 40, 1, corr=3),
          _ev("kernel", "sm90_xmma_gemm_bf16", 10, 10, corr=1, tid=7),
          _ev("kernel", "ncclKernel_AllReduce", 25, 5, corr=2, tid=8),
          _ev("kernel", "ef_compress_kernel", 45, 10, corr=3, tid=7)]
    out = tracefold.fold(ev, {"m": ("ef_compress_kernel", [{"d": 8}])})
    parts = [(k["name"], k["part"], k["gemm"], k["nccl"])
             for k in out["kernels"]]
    assert parts == [("sm90_xmma_gemm_bf16", "model", True, False),
                     ("ncclKernel_AllReduce", "model", False, True),
                     ("ef_compress_kernel", "optimizer", False, False)]
    assert out["steps"] == 1 and out["window_s"] == pytest.approx(1e-4)
    assert out["busy_s"] == pytest.approx(25e-6)
    # each gap named by the innermost range open on the launching thread
    # when it began: 20-25 us inside backward, 30-45 us in the step
    assert dict(out["idle_gaps"]) == {
        tracefold.BACKWARD_RANGE: pytest.approx(5e-6),
        tracefold.STEP_RANGE: pytest.approx(15e-6)}
    assert out["launches"] == {"m": [[{"d": 8}, pytest.approx(1e-5)]]}


def test_run_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine "
                    "without one")
    from portbench import run
    rc = run.main(["--workload", "bert-large.onebit.b128s128", "--seed",
                   "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_wire_counter_counts_every_gather_name(tmp_path):
    """The wire counter sees the program's gather under either of torch's
    names (``all_gather_single`` where torch has it), by group."""
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rv",
                            rank=0, world_size=1)
    try:
        x = torch.ones(5)
        out = torch.empty(5)
        names = [n for n in ("all_gather_into_tensor", "all_gather_single")
                 if hasattr(dist, n)]
        with harness.wire_counter({"dp": None}) as wire:
            for n in names:
                getattr(dist, n)(out, x)
            dist.all_reduce(x)
        assert wire == {"dp": 20 * (len(names) + 1)}
        assert all(getattr(dist, n).__name__ != "spy" for n in names)
    finally:
        dist.destroy_process_group()
