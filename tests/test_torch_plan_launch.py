"""The launcher's ``auto`` schedule axes and the planning benchmarks of the
port, against the JAX package where it has the same function.

  * ``launch.train.resolve_schedule`` gives the reference's pick (topology,
    bucket count, overlap, kernel path) for the same mesh shape, measured
    cluster JSON, flat dimension and device numbers: the port's kernel
    axis follows the device spec (``cuda`` = the reference's
    ``use_kernel="on"``, ``cpu`` = ``"off"``).
  * ``run`` with ``topology`` / ``pipeline`` / ``overlap_bwd`` ``"auto"``
    and the recipes ``onebit_adam_autotopo`` / ``onebit_adam_pipelined``
    no longer raise; on one process, and over 2 and 2 x 2 gloo ranks
    (spawned, a ``file://`` rendezvous under ``tmp_path``), an auto run's
    losses, parameters and state equal the explicit run's with the picked
    values, bitwise.  The CLI prints the ``[auto-schedule]`` line with
    ``--cluster`` and ``--device-spec``.
  * ``benchmarks.comm_volume --check-plans`` over gloo on 4 spawned CPU
    ranks: every plan's ``hlo_bytes()`` equals the bytes counted at the
    ``torch.distributed`` call boundary, exactly; ``comm_sweep`` over
    gloo on 2 x 2 ranks writes the JSON ``ClusterSpec.from_measured``
    reads (or refuses, as its ``clamped`` list says).
"""
import json
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.train import resolve_schedule as jresolve  # noqa: E402
from repro.perf.device import DeviceSpec as JDevice  # noqa: E402
from repro_torch.benchmarks import comm_sweep, comm_volume  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as L  # noqa: E402
from repro_torch.perf.device import DeviceSpec as TDevice  # noqa: E402
from repro_torch.plan.cost import ClusterSpec  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_hier_worker as hw  # noqa: E402

DEV = dict(peak_flops=3.0e14, hbm_bw=1.5e12, kernel_overhead=8e-6)
SMALL = dict(arch="bert-base-smoke", steps=4, warmup_steps=2, seq=32,
             block_size=512, lr=2e-3, lr_warmup=2)


def _links(path, cross_bw):
    with open(path, "w") as f:
        json.dump({"name": "links", "intra": {"latency": 2e-6,
                                              "bandwidth": 2e11},
                   "cross": {"latency": 5e-5, "bandwidth": cross_bw},
                   "op_overhead": 5e-6, "clamped": []}, f)
    return "measured:" + str(path)


def _jmesh(sizes):
    axes = ("data", "model") if len(sizes) == 1 else ("pod", "data", "model")
    return types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, tuple(sizes) + (1,))))


@pytest.mark.parametrize("arch", ["bert-base-smoke", "bert-large"])
@pytest.mark.parametrize("sizes", [(1,), (4,), (2, 2), (2, 4)])
@pytest.mark.parametrize("cross_bw", [1.25e9, 2e11])
@pytest.mark.parametrize("backend", ["cpu", "cuda"])
@pytest.mark.parametrize("axes", [("auto", "auto", "auto"),
                                  ("auto", "off", "off"),
                                  ("hier", "auto", "on")])
def test_resolve_schedule_matches_reference(tmp_path, arch, sizes, cross_bw,
                                            backend, axes):
    cluster = _links(tmp_path / "links.json", cross_bw)
    topology, pipeline, overlap = axes
    n = int(np.prod(sizes))
    want = jresolve(topology, pipeline, cluster, jget_config(arch),
                    _jmesh(sizes), "onebit", 4096, verbose=False,
                    use_kernel="on" if backend == "cuda" else "off",
                    device=JDevice("d", **DEV), overlap_bwd=overlap,
                    batch=8 * n, seq=64)
    got = L.resolve_schedule(topology, pipeline, overlap, cluster=cluster,
                             cfg=get_config(arch), dp_sizes=sizes,
                             compressor="onebit", block_size=4096,
                             device_spec=TDevice("d", **DEV,
                                                 backend=backend),
                             batch=8 * n, seq=64, verbose=False)
    assert got[:3] == (want[0], want[1], want[3])
    assert got[3].best.use_kernel == want[2]


def test_explicit_axes_pass_through():
    assert L.resolve_schedule("hier", "3", "on")[:3] == ("hier", 3, True)
    assert L.resolve_schedule("flat", "off", "off") == ("flat", 1, False,
                                                        None)
    with pytest.raises(ValueError):
        L.resolve_schedule("ring", "off", "off")
    with pytest.raises(ValueError):
        L.resolve_schedule("flat", "0", "off")


def _same_runs(a, b):
    assert [h["loss"] for h in a["history"]] == \
        [h["loss"] for h in b["history"]]
    assert torch.equal(a["state"].x, b["state"].x)
    for k in b["state"].opt:
        assert torch.equal(a["state"].opt[k], b["state"].opt[k]), k


def test_auto_run_and_recipes_on_one_process(capsys):
    auto = L.run(device="cpu", batch=4, topology="auto", pipeline="auto",
                 overlap_bwd="auto", **SMALL)
    pick = auto["schedule"]
    assert "[auto-schedule] cluster=ethernet-10g (1 pod(s) x 1 dp, " \
        "device=cpu-host)" in capsys.readouterr().out
    assert (auto["topology"], auto["n_buckets"], auto["overlap_bwd"]) == \
        (pick.topology, pick.n_buckets, pick.overlap_bwd)
    explicit = L.run(device="cpu", batch=4, topology=pick.topology,
                     pipeline=str(pick.n_buckets),
                     overlap_bwd="on" if pick.overlap_bwd else "off",
                     verbose=False, **SMALL)
    assert explicit["schedule"] is None
    _same_runs(auto, explicit)
    for recipe, pipeline in (("onebit_adam_autotopo", "off"),
                             ("onebit_adam_pipelined", "auto")):
        res = L.run(device="cpu", batch=4, recipe=recipe, verbose=False,
                    **SMALL)
        want = L.resolve_schedule(
            "auto", pipeline, "off", cluster="ethernet-10g",
            cfg=get_config(SMALL["arch"]), block_size=SMALL["block_size"],
            device_spec="cpu-host", batch=4, seq=SMALL["seq"],
            verbose=False)
        assert (res["topology"], res["n_buckets"], res["overlap_bwd"]) == \
            want[:3]
        assert all(np.isfinite(h["loss"]) for h in res["history"])


def test_cli_prints_the_pick(tmp_path, capsys):
    spec = tmp_path / "dev.json"
    with open(spec, "w") as f:
        json.dump({"name": "calibrated", "hbm_bw": 2e10,
                   "kernel_overhead": 5e-5, "peak_flops": 2e11,
                   "backend": "cpu", "clamped": []}, f)
    L.main(["--device", "cpu", "--arch", "bert-base-smoke", "--steps", "3",
            "--warmup-steps", "2", "--batch", "4", "--seq", "32",
            "--block-size", "512", "--recipe", "onebit_adam_pipelined",
            "--cluster", "uniform", "--device-spec", f"measured:{spec}"])
    out = capsys.readouterr().out
    assert "[auto-schedule] cluster=uniform (1 pod(s) x 1 dp, " \
        "device=calibrated): picked 'flat'" in out
    assert "kernels=plain" in out and "kernels=cuda" not in out


@pytest.mark.parametrize("mesh,sizes", [("2", (2,)), ("2x2x1", (2, 2))])
def test_auto_run_equals_explicit_over_gloo(tmp_path, mesh, sizes):
    import torch.multiprocessing as mp
    n = int(np.prod(sizes))
    base = dict(SMALL, mesh=mesh, batch=4 * n, recipe="onebit_adam")
    topo, nb, ob, tuned = L.resolve_schedule(
        "auto", "auto", "auto", cluster="ethernet-10g",
        cfg=get_config(SMALL["arch"]), dp_sizes=sizes, compressor="onebit",
        block_size=SMALL["block_size"], device_spec="cpu-host",
        batch=base["batch"], seq=SMALL["seq"], verbose=False)
    runs = {"auto": dict(base, topology="auto", pipeline="auto",
                         overlap_bwd="auto"),
            "explicit": dict(base, topology=topo, pipeline=str(nb),
                             overlap_bwd="on" if ob else "off")}
    with open(tmp_path / "runs.json", "w") as f:
        json.dump(runs, f)
    mp.start_processes(hw.run_main, args=(n, str(tmp_path), "gloo"),
                       nprocs=n, start_method="spawn")
    for r in range(n):
        got = np.load(tmp_path / f"run{r}.npz")
        assert str(got["auto__plan"]) == str(got["explicit__plan"])
        assert str(got["auto__plan"]).startswith(
            f"pipe({topo}/onebit)x{nb}" if nb > 1 else f"{topo}/onebit")
        # everything but the step walls
        names = [k[len("explicit__"):] for k in got.files
                 if k.startswith("explicit__") and k != "explicit__ms"]
        assert "x" in names and "opt_worker_err" in names
        for k in names:
            np.testing.assert_array_equal(got[f"auto__{k}"],
                                          got[f"explicit__{k}"],
                                          err_msg=f"{k} rank {r}")
        assert np.isfinite(got["auto__loss"]).all()


def test_comm_volume_check_plans_exact_over_gloo():
    table = comm_volume.check_plans(d=1 << 16, block=1024, device="cpu",
                                    verbose=False)
    kinds = ("identity", "onebit", "topk")
    assert sorted(table) == sorted(
        f"{p}{t}/{k}" for p in ("", "pipe2/", "pipe4/")
        for t in ("flat", "hier") for k in kinds)
    assert all(row["match"] and row["predicted"] > 0
               for row in table.values())


def test_comm_sweep_over_gloo_writes_the_cluster_json(tmp_path):
    path = str(tmp_path / "links.json")
    out = comm_sweep.run("2x2x1", sizes=(4096, 1 << 16), device="cpu",
                         json_path=path, verbose=False)
    assert (out["n_inner"], out["n_outer"]) == (2, 2)
    assert len(out["samples"]) == 2 * 2 * 2      # tiers x kinds x sizes
    assert {(s["tier"], s["op"], s["n"]) for s in out["samples"]} == {
        (t, k, 2) for t in ("intra", "cross")
        for k in ("AllReduce", "ReduceScatter")}
    if out["clamped"]:
        with pytest.raises(ValueError, match="clamped"):
            ClusterSpec.from_measured(path)
    else:
        spec = ClusterSpec.from_measured(path, n_inner=4, n_outer=2)
        assert spec.intra.bandwidth == out["intra"]["bandwidth"]
        assert spec.n_total == 8
