"""The port's device model (``repro_torch.perf``) and its calibration
(``repro_torch.benchmarks.kernel_sweep``) against the JAX package's
``repro.perf`` and ``benchmarks/kernel_sweep.py``.

  * ``DeviceSpec.roofline_time``, ``ComputeSpec`` arithmetic and the
    closed forms ``elementwise_pass``, ``adam_update_cost``,
    ``ef_combine_cost`` and ``combine_cost``: equal as Python floats on
    the same numbers.
  * Every compressor's ``compute_specs`` (the fused path and the unfused
    chain) and ``compressor_has_kernel``: equal to the reference's; the
    fused byte counts are PERF.md's bound column (12d + d/8 + 4d/block,
    4d + d/8 + 4d/block, 28d).
  * The presets: ``h100-sxm`` is the data sheet, ``cpu-host`` the
    reference's; ``from_measured`` loads what the reference loads and
    refuses a clamped fit; ``as_device`` takes ``measured:<path>``.
  * ``fit_device`` recovers known coefficients from synthetic samples
    (rel 1e-9) and names the terms it cannot resolve; a CPU sweep at
    toy sizes writes a JSON that ``from_measured`` loads or refuses as
    its ``clamped`` list says.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.optim import compressor_has_kernel as jcompressor_has_kernel  # noqa: E402,E501
from repro.optim import get_compressor as jget_compressor  # noqa: E402
from repro.perf import device as jdevice  # noqa: E402
from repro.perf import kernel_cost as jcost  # noqa: E402
from repro_torch.benchmarks import kernel_sweep  # noqa: E402
from repro_torch.optim import compressors as tcomp  # noqa: E402
from repro_torch.perf import device as tdevice  # noqa: E402
from repro_torch.perf import kernel_cost as tcost  # noqa: E402

DEVICE = dict(peak_flops=3.1e14, hbm_bw=1.7e12, kernel_overhead=4e-6)
SIZES = (4096, 65536, 1 << 20, 3 * (1 << 20))


def _spec(x):
    return (x.flops, x.hbm_bytes, x.kernels)


@pytest.mark.parametrize("flops,nbytes,kernels", [
    (0.0, 0.0, 0), (1e12, 1e6, 1), (1e6, 1e9, 3), (5e13, 2e10, 7)])
def test_roofline_time_matches_reference(flops, nbytes, kernels):
    j = jdevice.DeviceSpec("x", **DEVICE)
    t = tdevice.DeviceSpec("x", **DEVICE)
    assert t.roofline_time(flops, nbytes, kernels) == \
        j.roofline_time(flops, nbytes, kernels)
    js = jcost.ComputeSpec(flops, nbytes, kernels)
    ts = tcost.ComputeSpec(flops, nbytes, kernels)
    assert _spec(ts + ts) == _spec(js + js)
    assert ts.time(t) == js.time(j)


@pytest.mark.parametrize("d", SIZES)
def test_closed_forms_match_reference(d):
    for n_read, n_write, f in ((1, 1, 1.0), (2, 1, 1.0), (4, 3, 12.0)):
        assert _spec(tcost.elementwise_pass(d, n_read, n_write, f)) == \
            _spec(jcost.elementwise_pass(d, n_read, n_write, f))
    for fused in (False, True):
        assert _spec(tcost.adam_update_cost(d, fused)) == \
            _spec(jcost.adam_update_cost(d, fused))
    assert _spec(tcost.ef_combine_cost(d)) == _spec(jcost.ef_combine_cost(d))
    for n in (1, 2, 4, 8):
        assert _spec(tcost.combine_cost(d, n)) == \
            _spec(jcost.combine_cost(d, n))
    assert tcost.adam_update_cost(d, True).hbm_bytes == 28 * d


@pytest.mark.parametrize("name", ["onebit", "identity", "topk"])
@pytest.mark.parametrize("block", [256, 4096])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_compute_specs_match_reference(name, block, use_kernel):
    kw = {"use_kernel": True} if (use_kernel and name == "onebit") else {}
    j = jget_compressor(name, block_size=block, **kw)
    t = tcomp.get_compressor(name, block_size=block)
    assert tcomp.compressor_has_kernel(name) == \
        jcompressor_has_kernel(name)
    for d in (block * 64, block * 4096):
        js, ts = j.compute_specs(d), t.compute_specs(d, use_kernel)
        assert sorted(js) == sorted(ts)
        for k in js:
            assert _spec(ts[k]) == _spec(js[k]), (name, d, k)


@pytest.mark.parametrize("block", [512, 4096])
def test_fused_byte_counts_are_the_bound_column(block):
    """PERF.md's bound: ef_compress 12d + d/8 + 4d/block, decompress
    4d + d/8 + 4d/block; one launch each."""
    d = 64 * block
    specs = tcomp.get_compressor("onebit", block_size=block).compute_specs(
        d, use_kernel=True)
    assert specs["ef_compress"].hbm_bytes == 12 * d + d // 8 + 4 * d // block
    assert specs["decompress"].hbm_bytes == 4 * d + d // 8 + 4 * d // block
    assert specs["ef_compress"].kernels == specs["decompress"].kernels == 1


def test_presets():
    h100 = tdevice.get_device("h100-sxm")
    assert (h100.peak_flops, h100.hbm_bw, h100.hbm_bytes) == \
        (989e12, 3.35e12, 80 * 10 ** 9)
    assert h100.runs_kernels and h100.backend == "cuda"
    cpu, jcpu = tdevice.get_device("cpu-host"), jdevice.get_device("cpu-host")
    assert (cpu.peak_flops, cpu.hbm_bw, cpu.kernel_overhead, cpu.hbm_bytes,
            cpu.ici_bw) == (jcpu.peak_flops, jcpu.hbm_bw,
                            jcpu.kernel_overhead, jcpu.hbm_bytes,
                            jcpu.ici_bw)
    assert not cpu.runs_kernels
    assert cpu.hbm_capacity == jcpu.hbm_capacity
    assert tdevice.list_devices() == ["cpu-host", "h100-sxm"]
    assert tdevice.as_device("h100-sxm") is h100
    # one kernel's bound: the H100 data sheet's HBM rate and the peak of
    # the operations' type, whichever binds
    assert tdevice.H100_OPS_PER_S["bf16"] == h100.peak_flops
    assert tdevice.kernel_bound(3.35e9, 1.0) == (1.0, "bytes")
    assert tdevice.kernel_bound(0.0, 67e9) == (1.0, "operations")
    assert tdevice.kernel_bound(0.0, 495e9, "tf32") == (1.0, "operations")
    with pytest.raises(KeyError):
        tdevice.kernel_bound(0.0, 1.0, "f64")
    with pytest.raises(KeyError):
        tdevice.get_device("tpu-v5e")
    with pytest.raises(ValueError):
        tdevice.DeviceSpec("x", **DEVICE, backend="tpu")


def _write(path, **fit):
    with open(path, "w") as f:
        json.dump(fit, f)
    return str(path)


def test_from_measured_matches_reference(tmp_path):
    path = _write(tmp_path / "d.json", name="m", hbm_bw=2.9e12,
                  kernel_overhead=6.5e-6, peak_flops=7.1e14, clamped=[])
    j = jdevice.DeviceSpec.from_measured(path)
    t = tdevice.DeviceSpec.from_measured(path)
    assert (t.name, t.hbm_bw, t.kernel_overhead, t.peak_flops) == \
        (j.name, j.hbm_bw, j.kernel_overhead, j.peak_flops)
    assert t.backend == "cuda" and t.hbm_bytes == 80 * 10 ** 9
    assert tdevice.as_device("measured:" + path) == t
    # a fit that did not observe the FLOPs takes the base preset's
    nopeak = _write(tmp_path / "n.json", hbm_bw=1e11, kernel_overhead=1e-5,
                    peak_flops=None, backend="cpu")
    t = tdevice.DeviceSpec.from_measured(nopeak, base="cpu-host")
    assert t.peak_flops == 2e11 and not t.runs_kernels


def test_from_measured_refuses_a_clamped_fit(tmp_path):
    path = _write(tmp_path / "c.json", hbm_bw=1e24, kernel_overhead=1e-9,
                  peak_flops=None, clamped=["hbm_bw"])
    with pytest.raises(ValueError, match="clamped"):
        tdevice.DeviceSpec.from_measured(path)
    with pytest.raises(ValueError, match="clamped"):
        tdevice.as_device("measured:" + path)


def _synthetic(overhead, bw, peak, with_matmul=True):
    samples = []
    for d in (1 << 16, 1 << 20, 1 << 24):
        for k, nbytes in ((1, 12 * d), (2, 24 * d), (8, 96 * d),
                          (1, 28 * d)):
            samples.append({"op": "x", "d": d, "kernels": k,
                            "hbm_bytes": nbytes, "flops": d,
                            "seconds": k * overhead + nbytes / bw
                            + d / peak})
        if with_matmul:
            m = 1 << 10
            samples.append({"op": "mm", "d": d, "kernels": 1,
                            "hbm_bytes": 6 * m * m, "flops": 2 * m ** 3,
                            "seconds": overhead + 6 * m * m / bw
                            + 2 * m ** 3 / peak})
    return samples


@pytest.mark.parametrize("overhead,bw,peak", [
    (5e-6, 3.0e12, 8e14), (2e-5, 2.5e10, 2e11)])
def test_fit_device_recovers_known_coefficients(overhead, bw, peak):
    fit = kernel_sweep.fit_device(_synthetic(overhead, bw, peak))
    assert fit["clamped"] == []
    assert fit["kernel_overhead"] == pytest.approx(overhead, rel=1e-9)
    assert fit["hbm_bw"] == pytest.approx(bw, rel=1e-9)
    assert fit["peak_flops"] == pytest.approx(peak, rel=1e-9)
    # the reference's (unweighted) fit reads the same exact samples alike
    from benchmarks.kernel_sweep import fit_device as jfit_device
    jfit = jfit_device(_synthetic(overhead, bw, peak))
    assert jfit["hbm_bw"] == pytest.approx(fit["hbm_bw"], rel=1e-6)


def test_fit_device_names_what_it_cannot_resolve():
    # each launch takes a microsecond off: the fitted overhead is negative;
    # no sample does FLOPs
    samples = [{"op": "x", "d": d, "kernels": k, "hbm_bytes": 12 * d,
                "flops": 0.0, "seconds": 12 * d / 3e12 - 1e-6 * k}
               for d in (1 << 22, 1 << 23, 1 << 24) for k in (1, 2, 4, 8)]
    fit = kernel_sweep.fit_device(samples)
    assert fit["peak_flops"] is None
    assert fit["clamped"] == ["kernel_overhead"]
    with pytest.raises(ValueError):
        kernel_sweep.fit_device([])


def test_cpu_sweep_writes_what_from_measured_reads(tmp_path):
    path = str(tmp_path / "cpu.json")
    out = kernel_sweep.run(sizes=(1 << 12, 1 << 14), block=512,
                           device="cpu", json_path=path, verbose=False)
    with open(path) as f:
        data = json.load(f)
    assert data["backend"] == "cpu" and data["card"] == "cpu"
    ops = {s["op"] for s in data["samples"]}
    assert ops == {"ef_compress", "decompress", "adam_step", "add_x1",
                   "add_x2", "add_x4", "add_x8", "matmul_bf16"}
    # the plain chain's declared specs on the CPU
    ef = [s for s in data["samples"] if s["op"] == "ef_compress"][0]
    assert ef["kernels"] == 6
    if out["clamped"]:
        with pytest.raises(ValueError, match="clamped"):
            tdevice.DeviceSpec.from_measured(path)
    else:
        spec = tdevice.DeviceSpec.from_measured(path)
        assert spec.hbm_bw == data["hbm_bw"] and not spec.runs_kernels
