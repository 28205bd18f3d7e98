"""The port's benchmark harness and its remaining scripts on the CPU,
against the JAX package where their output is the same:

  * ``repro_torch.benchmarks.run.ALL``: the reference's twelve names in
    its order; an entry that needs four cards is recorded as not run,
    and ``--only`` of one exits non-zero;
  * ``--json`` on a fixed result dict: the records of the reference's
    ``repro.obs.bench`` writer (all but the timestamp);
  * ``state_manifest``: its JSON text equals the reference's
    ``build_manifest()`` for the default grid;
  * ``kernel_micro --device cpu``: the reference's wire bytes and ratio,
    and no ``kernel_vs_ref_err`` (no kernel on the CPU);
  * ``overlap_check`` on one CPU rank prints SKIP and exits 0; its trace
    scan on a made-up trace parts each NCCL kernel's time under compute
    kernels from its time under NCCL kernels on another stream;
  * ``train_e2e --tiny --steps 4 --device cpu`` writes a checkpoint that
    the port's launcher resumes from.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import run as JRUN  # noqa: E402
from benchmarks import state_manifest as JMAN  # noqa: E402
from repro.core.compression import CompressionConfig, wire_bytes  # noqa: E402
from repro.obs import bench as JBENCH  # noqa: E402
from repro_torch.benchmarks import kernel_micro  # noqa: E402
from repro_torch.benchmarks import run as TRUN  # noqa: E402
from repro_torch.benchmarks import state_manifest as TMAN  # noqa: E402
from repro_torch.state import manifest_json  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# a result of each shape the benchmarks return: flat scalars with
# verdicts, a dict of row dicts, a list of labelled rows
RESULTS = {
    "resnet_convergence": {"final_adam": 0.0123, "final_onebit": 0.0456,
                           "onebit_matches_adam": True, "finite": True},
    "kernel_micro": {"d=65536": {"wire_bytes": 8256, "ratio": 31.8,
                                 "packed_bitwise": True},
                     "d=1048576": {"wire_bytes": 132096, "ratio": 31.8}},
    "comm_fraction": [{"network": "Ethernet", "gpus": 64, "frac": 0.94},
                      {"network": "InfiniBand", "gpus": 8, "frac": 0.21}],
    "overlap_check": {"collectives": 8, "overlapped": 7,
                      "details": [{"us": 10.5, "overlapped": True}],
                      "mesh": [2, 2]},
}


def test_all_names_in_reference_order():
    assert list(TRUN.ALL) == list(JRUN.ALL)
    assert set(TRUN.CARDS) == {"comm_volume", "comm_sweep",
                               "overlap_check"}
    assert all(callable(f) for f in TRUN.ALL.values())


def test_json_ledger_matches_reference_writer(tmp_path):
    path = str(tmp_path / "BENCH_all.json")
    payload = TRUN.write_json(path, RESULTS, list(RESULTS), "cpu")
    want = []
    for name, result in RESULTS.items():
        want += JBENCH.records_from_result(name, result)
    ref = JBENCH.write_ledger(str(tmp_path / "ref.json"), want)
    assert payload["schema"] == ref["schema"]
    assert payload["meta"]["device"] == "cpu"

    def strip(recs):
        return [{k: v for k, v in r.items() if k != "t"} for r in recs]
    assert strip(payload["records"]) == strip(ref["records"])
    with open(path) as f:
        assert strip(JBENCH.load_ledger(path)["records"]) == \
            strip(json.load(f)["records"])


def test_four_card_entry_not_run_without_cards(capsys):
    if torch.cuda.device_count() >= 4:
        pytest.skip("four cards present: the entry would run")
    assert TRUN.main(["--only", "overlap_check"]) == 1
    out = capsys.readouterr().out
    assert "not run: needs 4 cards" in out and "PASS" not in out


def test_state_manifest_text_equals_reference():
    assert manifest_json(TMAN.build_manifest()) == json.dumps(
        JMAN.build_manifest(), indent=2, sort_keys=True)


def test_kernel_micro_cpu_wire_bytes(capsys):
    res = kernel_micro.run(device="cpu")
    cfg = CompressionConfig()
    assert list(res) == [f"d={d}" for d in (1 << 16, 1 << 20)]
    for d in (1 << 16, 1 << 20):
        row = res[f"d={d}"]
        assert row["wire_bytes"] == wire_bytes(d, cfg)
        assert row["fp32_bytes"] == 4 * d
        assert row["ratio"] == round(4 * d / wire_bytes(d, cfg), 1)
        assert "kernel_vs_ref_err" not in row
    out = capsys.readouterr().out
    assert "no kernel on the CPU" in out and "PASS" not in out
    assert not kernel_micro.passes(res)


def test_overlap_check_one_rank_skips():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.overlap_check",
         "--device", "cpu", "--mesh", "1"],
        env=dict(os.environ, PYTHONPATH=os.path.abspath(SRC)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[SKIP] one rank: no collective" in proc.stdout


def test_overlap_check_parts_compute_from_nccl():
    from repro_torch.benchmarks.overlap_check import check_trace_overlap

    def kernel(name, stream, ts, dur):
        return {"cat": "kernel", "name": name, "ts": ts, "dur": dur,
                "args": {"stream": stream}}
    events = [kernel("ncclDevKernel_SendRecv", 20, 0, 100),
              kernel("repro_ef_compress", 7, 10, 30),
              kernel("ncclDevKernel_AllGather", 21, 80, 40),
              kernel("ncclDevKernel_AllReduce", 20, 300, 10),
              {"cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 400}]
    res = check_trace_overlap(events)
    assert (res["collectives"], res["overlapped"], res["kernels"]) == \
        (3, 2, 4)
    assert (res["overlapped_compute"], res["overlapped_nccl"]) == (1, 2)
    send, gather, reduce = res["details"]
    assert (send["hidden_us"], send["hidden_compute_us"],
            send["hidden_nccl_us"]) == pytest.approx((50, 30, 20))
    assert (gather["hidden_compute_us"], gather["hidden_nccl_us"]) == \
        pytest.approx((0, 20))
    assert not reduce["overlapped"] and reduce["hidden_us"] == 0


def test_train_e2e_tiny_checkpoint_resumes(tmp_path):
    from repro_torch.examples import train_e2e
    from repro_torch.launch.train import run
    ckpt = str(tmp_path / "onebit_bert.npz")
    out = train_e2e.main(["--tiny", "--steps", "4", "--device", "cpu",
                          "--ckpt", ckpt])
    assert os.path.exists(ckpt)
    assert os.path.exists(tmp_path / "onebit_bert_log.json")
    losses = [h["loss"] for h in out["history"]]
    assert np.isfinite(losses).all()
    res = run("bert-base-smoke", steps=5, batch=8, seq=64, lr=2e-3,
              lr_warmup=20, block_size=512, resume=ckpt, device="cpu",
              verbose=False)
    assert res["start_step"] == 4
    assert [h["step"] for h in res["history"]] == [4]
