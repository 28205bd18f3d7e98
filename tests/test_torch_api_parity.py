"""The JAX package's public functions against their counterparts in the
port, on the same numpy inputs, and the audit that keeps every public
name of ``src/repro/`` ported or exempt with a reason:

  * ``ast`` only: each public top-level name of each module of
    ``src/repro/`` is defined (or imported) in the port's module of the
    same path, or stands in :data:`EXEMPT` with its reason; no exempt name
    has a counterpart after all; and :data:`EXEMPT` is ROADMAP.md's "No
    counterpart" list, name for name;
  * ``core.compression.ef_decompress`` bitwise the reference's (1-bit and
    identity), ``compression_error_norm`` at rtol 1e-5 (the block means
    sum in another order);
  * ``state.slots.rank_shapes`` / ``init_global_state(abstract=True)`` the
    reference's shapes and dtypes, ``state_specs`` its PartitionSpecs' dims,
    for every layout of three optimizers; ``train.step.state_layout_ctx``
    the reference's ``StateLayout`` on a 2 x 2 mesh;
  * ``launch.train.resolve_topology`` / ``resolve_pipeline`` the
    reference's picks for one cluster and config (the reference's TPU v5e
    numbers given to the port as a device spec);
  * the per-module ``init_*`` / ``*_param_specs`` views the reference's
    shapes and split dims; ``models.common.init_linear``'s shape and law;
    ``launch.mesh.make_mesh`` / ``make_production_mesh`` on torch's fake
    process group;
  * ``core.comm.compressed_allreduce_hierarchical`` bitwise
    ``compressed_exchange`` over 2 x 2 gloo ranks, serial and over 2
    buckets;
  * ``obs.profile.find_trace_files`` / ``load_profile_dir`` on the
    directory ``launch.train --device cpu --profile`` writes; the trace
    holds one ``train.backward`` range a profiled step.
"""
import ast
import os
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import _torch_overlap_bwd_worker as worker  # noqa: E402

HERE = os.path.dirname(__file__)
REF = os.path.join(HERE, "..", "src", "repro")
PORT = os.path.join(HERE, "..", "src", "repro_torch")
ROADMAP = os.path.join(HERE, "..", "ROADMAP.md")

# every public name of src/repro/ with no counterpart in the port, and why
_HLO = ("reads compiled XLA HLO; the port joins device events to its "
        "spans through Kineto correlation ids (obs.profile.fold_trace)")
_STEP = ("the reference's jitted shard_map step and its PartitionSpecs; "
         "the port's step is train_step on one rank's TrainState "
         "(init_train_state), each rank taking its own batch rows")
_TILE = ("a Pallas grid tile or mask constant; each CUDA kernel fixes its "
         "own in csrc/")
_TPU = ("a TPU v5e number; the port's card is perf.device's h100-sxm "
        "preset")
EXEMPT = {
    "compat.py::shard_map": "JAX version shim",
    "compat.py::make_mesh": "JAX version shim",
    "compat.py::install": "JAX version shim",
    "testutils/reference.py::compressed_allreduce_reference":
        "the oracle the port's tests import",
    "obs/mem.py::compiled_memory":
        "reads a compiled XLA executable's memory analysis; the port reads "
        "the allocator around a step (obs.mem.StepMemory)",
    "obs/profile.py::hlo_scope_map": _HLO,
    "obs/trace.py::collective_signature":
        "reads compiled HLO's collectives; the port counts calls at the "
        "torch.distributed boundary (benchmarks.comm_volume)",
    "analysis/roofline.py::CompCost": _HLO,
    "analysis/roofline.py::parse_hlo_costs": _HLO,
    "analysis/roofline.py::analyze_compiled":
        "reads a compiled executable's cost analysis; the port counts a "
        "traced step (analysis.roofline.analyze_traced)",
    "configs/base.py::input_specs":
        "jax.ShapeDtypeStruct stand-ins; the dry run feeds meta tensors "
        "(launch.dryrun.input_batch)",
    "train/step.py::TrainStepConfig": _STEP,
    "train/step.py::make_train_step": _STEP,
    "train/step.py::train_state_specs": _STEP,
    "train/step.py::batch_specs": _STEP,
    "kernels/fused_adam/kernel.py::DEFAULT_TILE": _TILE,
    "kernels/flash_attn/kernel.py::DEFAULT_BQ": _TILE,
    "kernels/flash_attn/kernel.py::DEFAULT_BK": _TILE,
    "kernels/flash_attn/kernel.py::NEG_INF": _TILE,
    "perf/device.py::TPU_V5E": _TPU,
    "perf/device.py::PEAK_FLOPS_BF16": _TPU,
    "perf/device.py::HBM_BW": _TPU,
    "perf/device.py::ICI_BW": _TPU,
    "perf/device.py::HBM_BYTES": _TPU,
    "launch/train.py::resolve_kernels":
        "the kept contract: the tuner's kernel axis has one value (a CUDA "
        "tensor always takes the port's kernel)",
}
_KERNELS = ("the kept contract: a CUDA tensor always takes the port's "
            "kernel, a CPU tensor its plain version; there is no switch")
_DEVICE = ("the port runs on the card unless the caller asks for the CPU "
           "(--device cuda|cpu); the reference's platform is JAX's")
# every keyword, dataclass field and command-line flag of src/repro/ the
# port's file of the same path lacks (``file::Class.field``,
# ``file::func(keyword)``, ``file::--flag``), and why
EXEMPT_ARGS = {
    "configs/base.py::OptimSpec.use_kernel": _KERNELS,
    "launch/train.py::run(kernels)": _KERNELS,
    "launch/train.py::--kernels": _KERNELS,
    "launch/train.py::run(base_lr)":
        "named lr, as the CLI's --lr that sets it in both packages",
    "launch/train.py::run(mesh_shape)":
        "named mesh: a --mesh spelling (N, NxT, PxNxT) resolved over the "
        "process group, where the reference takes a JAX mesh shape",
}
# every keyword and flag the port adds to a file of the reference, and why
ADDED_ARGS = {
    "launch/train.py::run(lr)": "the reference's base_lr",
    "launch/train.py::run(mesh)": "the reference's mesh_shape",
    "launch/train.py::run(verbose)":
        "the per-step log on or off (tests and chip_smoke.py run quiet)",
    "launch/train.py::run(device_spec)":
        "the device the plan tuner prices, as the CLI's --device-spec",
    "launch/train.py::run(seq_parallel)":
        "Megatron sequence parallelism on the model axis; the reference's "
        "run reads it from its mesh context",
    "launch/train.py::--device-spec":
        "a preset or measured:<kernel_sweep.json> for the plan tuner (the "
        "reference prices its own TPU by --device)",
    "obs/report.py::log_b": "the second log as a positional, beside --diff",
    "benchmarks/comm_volume.py::--d":
        "the flat length of --check-plans (small on the CPU)",
    "benchmarks/comm_volume.py::--block":
        "the block size of --check-plans (small on the CPU)",
    "benchmarks/state_manifest.py::--tp":
        "the model-axis degree of the manifest's mesh",
}
# the DeepSeek-V3 archs' fields (moonlight-16b-a3b; the reference has none)
for _n, _why in (
        ("moe_kind", "the expert layer: the softmax-routed capacity layer "
                     "or the sigmoid-routed dropless layer"),
        ("moe_d_ff", "an expert's width apart from the dense d_ff"),
        ("n_shared_experts", "shared experts that see every token"),
        ("moe_gate_scale", "the scale of the renormalised sigmoid gates"),
        ("experts_held", "the routed experts this chip holds (an EP share)"),
        ("expert_first", "the first expert this chip holds"),
        ("n_dense_lead", "leading dense layers before the MoE layers"),
        ("kv_lora_rank", "MLA's latent width (0: no MLA)"),
        ("qk_nope_dim", "MLA's q/k dims a head without rope"),
        ("qk_rope_dim", "MLA's q/k dims a head with rope"),
        ("v_head_dim", "MLA's v dims a head")):
    ADDED_ARGS[f"configs/base.py::ArchConfig.{_n}"] = _why
for _f in ("benchmarks/comm_sweep.py", "benchmarks/comm_volume.py",
           "benchmarks/kernel_sweep.py", "benchmarks/overlap_check.py",
           "benchmarks/run.py", "benchmarks/variance_stability.py",
           "examples/serve_decode.py", "examples/train_e2e.py"):
    ADDED_ARGS[f"{_f}::--device"] = _DEVICE


# --------------------------------------------------------------------------
# the audit
# --------------------------------------------------------------------------

def _top_names(path):
    """{name: defined here (True) or imported (False)} at module level."""
    out = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = True
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for n in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(n, ast.Name):
                        out[n.id] = True
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                out.setdefault((a.asname or a.name).split(".")[0], False)
    return out


def _missing():
    """``module.py::name`` of every public name the reference defines at
    module level and the port's module of the same path lacks."""
    out = set()
    for root, _, files in os.walk(REF):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), REF)
            port = os.path.join(PORT, rel)
            have = _top_names(port) if os.path.exists(port) else {}
            for name, defined in _top_names(os.path.join(root, f)).items():
                if defined and not name.startswith("_") and name not in have:
                    out.add(f"{rel.replace(os.sep, '/')}::{name}")
    return out


def test_every_public_name_has_a_counterpart_or_a_reason():
    missing = _missing()
    assert missing - set(EXEMPT) == set(), "ported nowhere, exempt nowhere"
    assert set(EXEMPT) - missing == set(), "exempt, yet the port has it"
    assert all(len(why) > 10 for why in EXEMPT.values())


def test_exemptions_are_roadmaps_no_counterpart_list():
    text = open(ROADMAP).read()
    start = text.index("**No counterpart**")
    end = re.compile(r"^\*\*|^#", re.M).search(text, start + 2).start()
    listed = set(re.findall(r"`([\w/]+\.py::\w+)`", text[start:end]))
    assert listed == set(EXEMPT)


def _fields(path, cls):
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            return {n.target.id for n in node.body
                    if isinstance(n, ast.AnnAssign)}
    raise KeyError(cls)


def _keywords(path, fn):
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.FunctionDef) and node.name == fn:
            a = node.args
            return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    raise KeyError(fn)


def _flags(path):
    """Every string given to an ``add_argument`` call in ``path``."""
    out = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", None) == "add_argument":
            out |= {a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str)}
    return out


def _cli_files():
    """(reference file, port file, name): every file of src/repro/ and of
    the top-level benchmarks/ and examples/ with an ``add_argument``;
    the latter two map to src/repro_torch/benchmarks/ and /examples/."""
    top = os.path.join(HERE, "..")
    out = []
    for root, _, files in os.walk(REF):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REF)
                out.append((os.path.join(root, f), os.path.join(PORT, rel),
                            rel.replace(os.sep, "/")))
    for sub in ("benchmarks", "examples"):
        for f in sorted(os.listdir(os.path.join(top, sub))):
            if f.endswith(".py"):
                out.append((os.path.join(top, sub, f),
                            os.path.join(PORT, sub, f), f"{sub}/{f}"))
    return [c for c in out if _flags(c[0])]


def _arg_differences():
    """(missing, added): ``file::...`` of every dataclass field, ``run``
    keyword and CLI flag the reference has and the port lacks, and of
    every one the port adds."""
    missing, added = set(), set()
    base = "configs/base.py"
    for cls in ("ArchConfig", "OptimSpec", "InputShape"):
        ref, port = _fields(os.path.join(REF, base), cls), \
            _fields(os.path.join(PORT, base), cls)
        missing |= {f"{base}::{cls}.{n}" for n in ref - port}
        added |= {f"{base}::{cls}.{n}" for n in port - ref}
    train = "launch/train.py"
    ref, port = _keywords(os.path.join(REF, train), "run"), \
        _keywords(os.path.join(PORT, train), "run")
    missing |= {f"{train}::run({n})" for n in ref - port}
    added |= {f"{train}::run({n})" for n in port - ref}
    for ref_path, port_path, name in _cli_files():
        assert os.path.exists(port_path), f"no port of {name}"
        ref, port = _flags(ref_path), _flags(port_path)
        missing |= {f"{name}::{n}" for n in ref - port}
        added |= {f"{name}::{n}" for n in port - ref}
    return missing, added


def test_config_fields_run_keywords_and_cli_flags():
    missing, added = _arg_differences()
    assert missing == set(EXEMPT_ARGS), "missing in the port, exempt nowhere"
    assert added == set(ADDED_ARGS), "added by the port, explained nowhere"
    assert all(len(why) > 10 for why in EXEMPT_ARGS.values())
    assert all(len(why) > 10 for why in ADDED_ARGS.values())
    assert "configs/base.py::ArchConfig.remat_policy" not in missing
    assert len(_cli_files()) >= 14


def test_exempt_arguments_are_roadmaps_lists():
    text = open(ROADMAP).read()
    pattern = re.compile(r"`([\w/]+\.py::(?:[\w.]+\(\w+\)|--[\w-]+|"
                         r"\w+\.\w+|\w+))`")

    def listed(head):
        start = text.index(head)
        end = re.compile(r"^\*\*|^#", re.M).search(text, start + 2).start()
        return set(pattern.findall(text[start:end]))
    assert listed("**No counterpart**") == set(EXEMPT) | set(EXEMPT_ARGS)
    assert listed("**Added by the port**") == set(ADDED_ARGS)


# --------------------------------------------------------------------------
# compression, state, schedule resolution
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["onebit", "identity"])
def test_ef_decompress_and_error_norm(kind):
    from repro.core import compression as J
    from repro_torch.core import compression as T
    rng = np.random.default_rng(3)
    x = rng.standard_normal(8 * 512).astype(np.float32)
    err = (0.1 * rng.standard_normal(8 * 512)).astype(np.float32)
    jcfg, tcfg = J.CompressionConfig(kind, 512), T.CompressionConfig(kind,
                                                                      512)
    jpay, _ = J.ef_compress(jnp.asarray(x), jnp.asarray(err), jcfg)
    tpay, _ = T.ef_compress(torch.from_numpy(x), torch.from_numpy(err), tcfg)
    # one payload: the reference's, decompressed by each package
    pay = tuple(torch.from_numpy(np.array(p)) for p in jpay)
    np.testing.assert_array_equal(T.ef_decompress(pay, tcfg).numpy(),
                                  np.asarray(J.ef_decompress(jpay, jcfg)))
    np.testing.assert_array_equal(tpay[0].numpy(), np.asarray(jpay[0]))
    np.testing.assert_allclose(
        float(T.compression_error_norm(torch.from_numpy(x), 512)),
        float(J.compression_error_norm(jnp.asarray(x), 512)), rtol=1e-5)


@pytest.mark.parametrize("opt", ["onebit_adam", "onebit_lamb",
                                 "zerone_adam"])
@pytest.mark.parametrize("layout", ["replicated", "local", "zero1"])
def test_rank_shapes_global_state_and_specs(opt, layout):
    from repro.optim import get_optimizer as jget
    from repro.state import (StateLayout as JLayout, init_global_state as
                             jinit, rank_shapes as jrank, state_specs as
                             jspecs)
    from repro_torch.optim import get_optimizer as tget
    from repro_torch.state import (StateLayout, init_global_state,
                                   rank_shapes, state_specs)
    kw = dict(d=8 * 4096, n_dp=4, n_srv=2, n_outer=2, n_segments=5,
              dp_sizes=(2, 2), tp=2)
    jslots, tslots = jget(opt).state_slots(layout), \
        tget(opt).state_slots(layout)
    jr, tr = jrank(jslots, JLayout(**kw)), rank_shapes(tslots,
                                                       StateLayout(**kw))
    assert list(jr) == list(tr)
    for k in jr:
        assert tuple(jr[k][0]) == tr[k][0], k
        assert str(jr[k][1]) == str(tr[k][1]).removeprefix("torch."), k
    jg = jinit(jslots, JLayout(**kw), abstract=True)
    tg = init_global_state(tslots, StateLayout(**kw), abstract=True)
    for k in jg:
        assert tuple(jg[k].shape) == tuple(tg[k].shape) and \
            tg[k].device.type == "meta", k
    js = jspecs(jslots, ("pod", "data"))
    ts = state_specs(tslots, ("pod", "data"))
    assert {k: tuple(v) for k, v in js.items()} == dict(ts)


def _jmesh(sizes):
    axes = ("data", "model") if len(sizes) == 1 else ("pod", "data", "model")
    return types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, tuple(sizes) + (1,))))


@pytest.mark.parametrize("topology", ["flat", "hier"])
def test_state_layout_ctx(topology):
    from repro.configs import get_config as jget_config
    from repro.train.step import state_layout_ctx as jctx
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import DpMesh
    from repro_torch.train.step import mesh_axes, state_layout_ctx
    mesh = DpMesh(axes=("pod", "data"), sizes=(2, 2), groups={})
    assert mesh_axes(mesh) == (("pod", "data"), (2, 2), 1)
    want = jctx(jget_config("bert-base-smoke"), _jmesh((2, 2)), block=512,
                topology=topology)
    got = state_layout_ctx(get_config("bert-base-smoke"), mesh, block=512,
                           topology=topology)
    assert {f: getattr(got, f) for f in want.__dataclass_fields__} == \
        {f: getattr(want, f) for f in want.__dataclass_fields__}


@pytest.mark.parametrize("cross_bw", [1.25e9, 4e11])
def test_resolve_topology_and_pipeline(tmp_path, cross_bw):
    import json
    from repro.configs import get_config as jget_config
    from repro.launch.train import (resolve_pipeline as jpipe,
                                    resolve_topology as jtopo)
    from repro.perf.device import DEVICES as JDEVICES
    from repro_torch.configs import get_config
    from repro_torch.launch.train import resolve_pipeline, resolve_topology
    from repro_torch.perf.device import DeviceSpec
    path = tmp_path / "links.json"
    with open(path, "w") as f:
        json.dump({"name": "links", "intra": {"latency": 2e-6,
                                              "bandwidth": 2e11},
                   "cross": {"latency": 5e-5, "bandwidth": cross_bw},
                   "op_overhead": 5e-6, "clamped": []}, f)
    cluster = f"measured:{path}"
    tpu = JDEVICES["tpu-v5e"]      # the device the reference's resolve_*
    dev = DeviceSpec("tpu-v5e", peak_flops=tpu.peak_flops,
                     hbm_bw=tpu.hbm_bw, kernel_overhead=tpu.kernel_overhead,
                     hbm_bytes=tpu.hbm_bytes, ici_bw=tpu.ici_bw,
                     backend="cpu")
    arch = "bert-large"
    jcfg, cfg = jget_config(arch), get_config(arch)
    kw = dict(device_spec=dev, batch=8, seq=128)
    want = jtopo("auto", cluster, jcfg, _jmesh((2, 4)), "onebit", 4096,
                 verbose=False)
    assert resolve_topology("auto", cluster, cfg, "2x4x1", "onebit", 4096,
                            verbose=False, **kw) == want
    for topo in ("flat", "hier"):
        want = jpipe("auto", topo, cluster, jcfg, _jmesh((2, 4)), "onebit",
                     4096, verbose=False)
        assert resolve_pipeline("auto", topo, cluster, cfg, "2x4x1",
                                "onebit", 4096, verbose=False, **kw) == want


# --------------------------------------------------------------------------
# models and meshes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,tp", [("llama3.2-3b-smoke", 1),
                                     ("llama3.2-3b-smoke", 2),
                                     ("bert-base-smoke", 1),
                                     ("mixtral-8x22b-smoke", 2),
                                     ("falcon-mamba-7b-smoke", 2)])
def test_per_module_init_and_specs(arch, tp):
    from jax.sharding import PartitionSpec
    from repro.configs import get_config as jget_config
    from repro.models import attention as JA, mlp as JM, ssm as JS
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A, mlp as M, ssm as S
    jcfg, cfg = jget_config(arch), get_config(arch)
    gen = torch.Generator().manual_seed(0)
    pairs = []
    if cfg.family == "ssm":
        pairs.append((JS.init_ssm, JS.ssm_param_specs, S.init_ssm,
                      S.ssm_param_specs))
    else:
        pairs.append((JA.init_attn, JA.attn_param_specs, A.init_attn,
                      A.attn_param_specs))
        pairs.append((JM.init_moe, JM.moe_param_specs, M.init_moe,
                      M.moe_param_specs) if cfg.n_experts else
                     (JM.init_mlp, JM.mlp_param_specs, M.init_mlp,
                      M.mlp_param_specs))
    for jinit, jspec, tinit, tspec in pairs:
        want = jax.eval_shape(lambda k: jinit(k, jcfg, tp),
                              jax.random.PRNGKey(0))
        got = tinit(gen, cfg, tp)
        assert list(got) == sorted(want)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert all(v.dtype == torch.float32 for v in got.values())
        dims = {k: next((i for i, a in enumerate(p) if a == "m"), None)
                for k, p in jspec(jcfg, "m").items()
                if isinstance(p, PartitionSpec)}
        assert tspec(cfg) == dims


def test_init_linear():
    from repro_torch.models.common import init_linear
    w = init_linear(torch.Generator().manual_seed(0), 400, 300)
    assert w.shape == (400, 300) and w.dtype == torch.float32
    assert abs(float(w.std()) * 20.0 - 1.0) < 0.01        # 1 / sqrt(400)
    w = init_linear(torch.Generator().manual_seed(0), 400, 300, scale=0.02)
    assert abs(float(w.std()) / 0.02 - 1.0) < 0.01


def test_make_mesh_and_production_mesh():
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.plan.executor import group_of
    # the reference's shapes (src/repro/launch/mesh.py:16-19)
    with fake_world(256):
        m = make_production_mesh()
        assert (m.axes, m.sizes, m.tp) == (("dp",), (16,), 16)
    with fake_world(512):
        m = make_production_mesh(multi_pod=True)
        assert (m.axes, m.sizes, m.tp) == (("pod", "data"), (2, 16), 16)
    with fake_world(8):
        m = make_mesh((2, 2, 2), ("slow", "fast", "model"))
        assert (m.axes, m.sizes, m.tp) == (("slow", "fast"), (2, 2), 2)
        for axes in (("slow",), ("fast",), ("slow", "fast"), ("model",),
                     ("model", "slow", "fast")):
            group_of(axes)            # every collective finds its group
        with pytest.raises(KeyError):
            group_of(("pod",))
    with pytest.raises(ValueError):
        make_mesh((2,), ("data", "model"))


# --------------------------------------------------------------------------
# the hierarchical exchange, the profile directory
# --------------------------------------------------------------------------

def test_hierarchical_wrapper_bitwise_exchange(tmp_path):
    block, d = 256, 4 * 4 * 256
    rng = np.random.default_rng(9)
    np.savez(tmp_path / "inputs.npz",
             xs=rng.standard_normal((4, d)).astype(np.float32))
    mp.start_processes(worker.hier_main, args=(4, str(tmp_path), block),
                       nprocs=4, start_method="spawn")
    for r in range(4):
        res = np.load(tmp_path / f"hier{r}.npz")
        keys = [k for k in res.files if k.startswith("exch")]
        assert {"exch1_out", "exch1_worker", "exch1_server",
                "exch2_out"} <= set(keys)
        for k in keys:
            np.testing.assert_array_equal(res["wrap" + k[4:]], res[k],
                                          err_msg=k)
        assert np.isfinite(res["exch2_out"]).all()


def test_find_trace_files_and_load_profile_dir(tmp_path):
    from repro_torch.benchmarks.overlap_check import check_bwd_trace
    from repro_torch.launch.train import run
    from repro_torch.obs.profile import (find_trace_files, load_profile_dir,
                                         load_trace_events)
    prof = str(tmp_path / "prof")
    run(arch="bert-base-smoke", device="cpu", steps=4, warmup_steps=2,
        batch=4, seq=32, block_size=512, pipeline="2", overlap_bwd="on",
        profile=prof, profile_steps=2, verbose=False)
    path = os.path.join(prof, "trace_rank0.json")
    assert os.path.exists(os.path.join(prof, "BENCH_train.json"))
    assert find_trace_files(prof) == [path]
    assert find_trace_files(prof, rank=0) == [path]
    assert find_trace_files(prof, rank=1) == []
    events = load_profile_dir(prof)
    assert events == load_trace_events(path) == load_profile_dir(prof, 0)
    res = check_bwd_trace(events)
    # gloo on the CPU: no collective kernel; one backward range a step
    assert res["pairs"] == 0 and res["backward_passes"] == 2


# --------------------------------------------------------------------------
# the last keyword and CLI gaps: auto_warmup, --auto-warmup, report --diff
# --------------------------------------------------------------------------

def _stages(**kw):
    from repro_torch.launch.train import run
    res = run(arch="bert-base-smoke", recipe="fast_variance", device="cpu",
              steps=8, batch=4, seq=32, block_size=512, lr_warmup=2,
              verbose=False, **kw)
    return [h["stage"] for h in res["history"]]


def test_auto_warmup_lets_the_variance_rule_pick(monkeypatch):
    """``auto_warmup=True`` with ``warmup_steps=6``: the stage flips where
    the Sec. 7.1 rule flips it with no manual T_w, not at step 6 (b2 0.5:
    the rule's window is 2 steps, so it fires within the run)."""
    from repro_torch.configs import base
    monkeypatch.setitem(base._OPTIM_RECIPES, "fast_variance",
                        base.OptimSpec(name="fast_variance",
                                       optimizer_kwargs={"b2": 0.5}))
    auto = _stages()
    flip = auto.index("compressed")
    assert 0 < flip < 6
    assert _stages(warmup_steps=6, auto_warmup=True) == auto
    assert _stages(warmup_steps=6).index("compressed") == 6


def test_auto_warmup_flag_reaches_run(monkeypatch):
    from repro_torch.launch import train
    seen = []
    monkeypatch.setattr(train, "run", lambda **kw: seen.append(kw))
    base = ["--device", "cpu", "--warmup-steps", "3"]
    train.main(base)
    train.main(base + ["--auto-warmup"])
    assert [(k["warmup_steps"], k["auto_warmup"]) for k in seen] == \
        [(3, False), (3, True)]


def test_report_diff_flag(tmp_path, capsys):
    """``obs.report A --diff B`` prints what ``obs.report A B`` prints, and
    what the reference's ``repro.obs.report A --diff B`` prints."""
    from repro.obs import report as JR
    from repro_torch.launch.train import run
    from repro_torch.obs import report as PR
    logs = []
    for i, steps in enumerate((3, 4)):
        res = run(arch="bert-base-smoke", device="cpu", steps=steps,
                  warmup_steps=2, batch=2, seq=16, block_size=512,
                  verbose=False, telemetry=str(tmp_path / f"t{i}"))
        logs.append(res["telemetry"])
    capsys.readouterr()
    out = []
    for argv in ([logs[0], "--diff", logs[1]], [logs[0], logs[1]]):
        assert PR.main(argv) == 0
        out.append(capsys.readouterr().out)
    assert JR.main([logs[0], "--diff", logs[1]]) == 0
    ref = capsys.readouterr().out
    assert out[0] == out[1] == ref
    assert out[0].startswith("== diff:")
    with pytest.raises(SystemExit):
        PR.main([logs[0], logs[1], "--diff", logs[1]])
