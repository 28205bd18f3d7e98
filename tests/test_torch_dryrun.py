"""The dry run and the roofline counter of the port against the JAX
reference on the CPU (``launch.dryrun``, ``analysis.roofline``, the kernel
ops' meta paths, ``benchmarks.comm_volume``'s volume measurement).

  * ``ASSIGNED`` and ``skip_reason`` equal the reference's;
  * ``RooflineReport`` on ``tests/test_system.py::TestRooflineParser``'s
    cases: the 7-step matmul loop and the nested dot counted by
    ``analyze_traced`` as the reference's ``analyze_compiled`` counts
    their compiled HLO, and the bottleneck fields priced on the h100-sxm
    preset; the summary has every key of the reference's;
  * one prefill of ``llama3.2-3b-smoke`` at tp 1: dot FLOPs within 1 % of
    the reference's ``analyze_compiled`` of its jitted prefill;
  * each kernel op on meta tensors: the plain version's shapes and
    dtypes, one stand-in launch recorded and priced;
  * ``measured_volumes`` of the identity and 1-bit flat exchanges equal
    the reference's compiled-HLO bytes, byte for byte;
  * every ``ASSIGNED`` arch's reduced config, for each shape (train and
    prefill cut to 128 tokens), traces on a 2 x 2 fake mesh;
  * ``python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape
    decode_32k`` at 16 x 16 exits 0 with its ``OK`` line.
"""
import dataclasses
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis.roofline import RooflineReport as JReport  # noqa: E402
from repro.analysis.roofline import analyze_compiled  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import ParallelCtx  # noqa: E402
from repro_torch.analysis.roofline import (H100, RooflineReport,  # noqa: E402
                                           analyze_traced)
from repro_torch.benchmarks import comm_volume  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.perf import kernel_cost  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module, imported with the process's
    XLA_FLAGS restored after it (its import sets 512 host devices for the
    backend it would start)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def test_assigned_and_skip_reasons_match_reference(jdryrun):
    assert dryrun.ASSIGNED == jdryrun.ASSIGNED
    for arch in jdryrun.ASSIGNED + ["bert-large"]:
        for shape in SHAPES:
            assert dryrun.skip_reason(arch, shape) == \
                jdryrun.skip_reason(arch, shape), (arch, shape)


# --------------------------------------------------------------------------
# the roofline report
# --------------------------------------------------------------------------

def test_loop_of_matmuls_counted_as_the_scanned_one():
    """The reference's scan of 7 (64, 64) matmuls: 2 * 64^3 * 7 FLOPs,
    its operand and result bytes 7 times, as its analyze_compiled."""
    def jf(x, w):
        def body(c, _):
            return c @ w, None
        return jax.lax.scan(body, x, None, length=7)[0]
    s = jax.ShapeDtypeStruct((64, 64), jnp.float32)
    want = analyze_compiled(jax.jit(jf).lower(s, s).compile())

    def f(x, w):
        for _ in range(7):
            x = x @ w
        return x
    x = torch.empty(64, 64, device="meta")
    rep, out = analyze_traced(f, x, x)
    assert tuple(out.shape) == (64, 64)
    assert rep.dot_flops == 2 * 64 ** 3 * 7
    assert abs(rep.dot_flops - want.dot_flops) / want.dot_flops < 0.01
    assert rep.hbm_bytes == 7 * 3 * 64 * 64 * 4 == want.hbm_bytes
    assert rep.coll_bytes == 0 and rep.kernels == {}


def test_nested_dot():
    def jf(a, b, c):
        return (a @ b) @ c
    s = jax.ShapeDtypeStruct((32, 32), jnp.float32)
    want = analyze_compiled(jax.jit(jf).lower(s, s, s).compile())
    t = torch.empty(32, 32, device="meta")
    rep, _ = analyze_traced(lambda a, b, c: (a @ b) @ c, t, t, t)
    assert abs(rep.dot_flops - 2 * 2 * 32 ** 3) < 1e-6
    assert rep.dot_flops == want.dot_flops


def test_bottleneck_fields():
    """The reference's case, priced on the h100-sxm preset: one second of
    compute, two of memory."""
    r = RooflineReport(dot_flops=H100.peak_flops, hbm_bytes=H100.hbm_bw * 2,
                       coll_bytes=0.0, coll_by_kind={})
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.bottleneck == "memory"
    assert r.step_time_lower_bound == pytest.approx(2.0)
    want = JReport(dot_flops=197e12, hbm_bytes=819e9 * 2, coll_bytes=0.0,
                   coll_by_kind={})
    assert set(want.summary()) <= set(r.summary())
    assert {f.name for f in dataclasses.fields(JReport)} <= \
        {f.name for f in dataclasses.fields(RooflineReport)}


def test_prefill_flops_match_reference():
    """One prefill of llama3.2-3b-smoke (B 2, S 64) at tp 1: the port's
    dot FLOPs within 1 % of the reference's compiled prefill."""
    jcfg = jget_config("llama3.2-3b-smoke")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    toks = np.zeros((2, 64), np.int32)
    comp = jax.jit(lambda p, b: JT.prefill(p, b, jcfg, ParallelCtx())[0]) \
        .lower(jparams, {"tokens": jnp.asarray(toks)}).compile()
    want = analyze_compiled(comp).dot_flops
    cfg = get_config("llama3.2-3b-smoke")
    params = {k: v.to("meta") for k, v in params_from_jax(
        jax.tree.map(np.asarray, jparams)).items()}
    with torch.inference_mode():
        rep, (logits, _) = analyze_traced(
            TT.prefill, params, {"tokens": torch.from_numpy(toks).to("meta")},
            cfg)
    assert tuple(logits.shape) == (2, cfg.padded_vocab(1))
    assert abs(rep.dot_flops - want) / want < 0.01, (rep.dot_flops, want)


# --------------------------------------------------------------------------
# the kernel ops on the meta device
# --------------------------------------------------------------------------

def _same_outputs(plain, meta):
    plain = plain if isinstance(plain, tuple) else (plain,)
    meta = meta if isinstance(meta, tuple) else (meta,)
    assert [(tuple(t.shape), t.dtype) for t in plain] == \
        [(tuple(t.shape), t.dtype) for t in meta]
    assert all(t.is_meta for t in meta)


@pytest.mark.parametrize("op", ["ef_compress", "decompress", "adam_step",
                                "flash_attention", "flash_attention_wgmma",
                                "flash_attention_wide"])
def test_kernel_op_meta_outputs(op):
    """Each op on meta tensors: empty outputs of the plain version's shapes
    and dtypes, one stand-in launch recorded and priced by
    perf.kernel_cost, and the launch counts left where they were."""
    from repro_torch.kernels.flash_attn import ops as FA
    from repro_torch.kernels.fused_adam import ops as AD
    from repro_torch.kernels.onebit import ops as OB
    g = torch.Generator().manual_seed(0)
    d, block = 8192 + 512, 512
    x, e = torch.randn(d, generator=g), torch.randn(d, generator=g)
    if op == "ef_compress":
        fn, args, cost = OB.ef_compress_fused, (x, e, block), \
            kernel_cost.ef_compress_cost(d, block)
    elif op == "decompress":
        packed, scales, _ = OB.ef_compress_fused(x, e, block)
        fn, args, cost = OB.decompress, (packed, scales, block), \
            kernel_cost.decompress_cost(d, block)
    elif op == "adam_step":
        fn, args = AD.adam_step, (x, e, e.abs(), x, 1e-3)
        cost = kernel_cost.adam_update_cost(16384, fused=True)
    else:
        dt, hd = {"flash_attention": (torch.float32, 64),
                  "flash_attention_wgmma": (torch.bfloat16, 128),
                  "flash_attention_wide": (torch.bfloat16, 320)}[op]
        q = torch.randn(1, 2, 256, hd, generator=g).to(dt)
        fn, args = FA.flash_attention, (q, q, q)
        cost = kernel_cost.flash_attention_cost(1, 2, 256, hd,
                                                q.element_size())
    meta_args = [a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args]
    before = build.launch_counts()
    with build.recording() as rec:
        got = fn(*meta_args)
    after = build.launch_counts()
    _same_outputs(fn(*args), got)
    # a stand-in launch reaches the recorders only: the counts that prove
    # a kernel ran do not move
    assert after == before
    assert rec == [(op, cost)]


# --------------------------------------------------------------------------
# the volume measurement and the traces
# --------------------------------------------------------------------------

def test_measured_volumes_match_reference():
    """The identity and 1-bit flat exchanges of 2^20 elements over 8
    ranks: the bytes handed to torch.distributed on the fake ranks equal
    the reference's compiled-HLO bytes, by kind."""
    sys.path.insert(0, ROOT)
    try:
        from benchmarks.comm_volume import measured_volumes as jmeasured
    finally:
        sys.path.remove(ROOT)
    kw = dict(kinds=("identity", "onebit"), topologies=("flat",))
    want = jmeasured(**kw)
    got = comm_volume.measured_volumes(**kw)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key]["bytes"] == int(want[key]["bytes"]), key
        assert got[key]["kinds"] == want[key]["kinds"], key


def test_volume_table_and_cost_report():
    """``run`` and ``cost_model_report`` without a card: the 1-bit wire
    compression past 10x and the hier schedule's cross-pod cut past
    n_inner / 2, as the reference's PASS lines."""
    out = comm_volume.run(verbose=False)
    assert out["wire_compression_x"] > 10.0
    assert out["hier_dci_reduction_x_onebit"] > comm_volume.VOL_INNER * 0.5
    w = 23_000 / 152_000
    assert out["paper_endtoend_volume_x_fp16"] == round(
        1 / (w + (1 - w) / 16), 2)
    rep = comm_volume.cost_model_report()
    assert set(rep) == {"uniform", "ethernet-10g", "infiniband",
                        "pipelined_hier_onebit"}


def _cut(shape):
    return shape if shape.kind == "decode" else \
        dataclasses.replace(shape, seq_len=128)


@pytest.mark.parametrize("arch", dryrun.ASSIGNED)
def test_reduced_archs_trace_on_a_fake_2x2_mesh(arch):
    """Every shape of ``arch``'s reduced config as rank 0 of a 2 x 2 fake
    mesh: a report with positive FLOPs and a peak, the collectives of the
    model axis counted; a decode launches no flash kernel, a bf16 prefill
    with attn_impl="pallas" one a layer."""
    for name, shape in SHAPES.items():
        if dryrun.skip_reason(arch, name):
            continue
        r = dryrun.lower_one(arch + "-smoke", _cut(shape),
                             mesh_override="2x2")
        rl = r["roofline"]
        assert r["mesh"] == "2x2" and r["n_chips"] == 4
        assert rl["dot_flops_per_dev"] > 0, name
        assert r["memory"]["peak_bytes"] > r["memory"]["arg_bytes"] > 0
        assert rl["coll_by_kind"].get("all-reduce", 0) > 0, name
        if shape.kind == "train":
            assert {k: v["launches"] for k, v in rl["kernels"].items()} == \
                {"ef_compress": 2, "decompress": 2, "lm_head_xent_fwd": 1,
                 "lm_head_xent_bwd": 1}, name
            assert "memory_ledger" in r
        if shape.kind == "decode":
            assert rl["kernels"] == {}
    cfg = get_config(arch + "-smoke")
    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    r = dryrun.lower_one(arch + "-smoke", _cut(SHAPES["prefill_32k"]),
                         mesh_override="2x2",
                         cfg_overrides={"attn_impl": "pallas",
                                        "compute_dtype": "bfloat16"})
    launches = {k: v["launches"] for k, v in r["roofline"]["kernels"].items()}
    assert launches == ({"flash_attention_wgmma": n_attn} if n_attn else {})


def test_dryrun_cli_at_16x16():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "llama3.2-3b", "--shape", "decode_32k"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK   llama3.2-3b x decode_32k x 16x16" in r.stdout
    assert "all 1 combinations OK" in r.stdout
