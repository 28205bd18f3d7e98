"""The benchmark's FLOP, byte and parameter counts against hand counts and
against the program's own layout."""
import importlib.util
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

from portbench.reference import transformer as R  # noqa: E402

CONFIGS = {n: json.loads((HERE / "configs" / f"{n}.json").read_text())
           for n in ("bert-large", "internlm2-1.8b")}


def _load(kind, name):
    spec = importlib.util.spec_from_file_location(
        f"t_{kind}_{name}".replace(".", "_").replace("-", "_"),
        HERE / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FLOPS = _load("flops", "dense_transformer")


def test_bert_large_step_flops_by_hand():
    c = CONFIGS["bert-large"]
    # 24 layers x (4 x 1024^2 attention + 2 x 1024 x 4096 MLP) + the LM
    # head 1024 x 30522
    per_layer = 4 * 1024 * 1024 + 2 * 1024 * 4096
    assert FLOPS.matmul_params(c) == 24 * per_layer + 1024 * 30522
    tokens, seq = 128 * 128, 128
    want = 6 * (24 * per_layer + 1024 * 30522) * tokens \
        + 12 * 24 * 1024 * 128 * tokens
    assert FLOPS.step_flops(c, tokens, seq) == want
    assert 3.3e13 < want < 3.4e13


def test_internlm2_step_flops_by_hand():
    c = CONFIGS["internlm2-1.8b"]
    # q and o 2048 x 2048, k and v 2048 x 1024 (8 of 16 heads), SwiGLU
    per_layer = 2 * 2048 * 2048 + 2 * 2048 * 1024 + 3 * 2048 * 8192
    assert FLOPS.matmul_params(c) == 24 * per_layer + 2048 * 92544
    tokens = 2 * 8 * 2048
    want = 6 * FLOPS.matmul_params(c) * tokens \
        + 12 * 24 * 2048 * 2048 * tokens
    assert FLOPS.step_flops(c, tokens, 2048) == want
    assert 3.6e14 < want < 3.8e14


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("tp", [1, 2])
def test_reference_layout_is_the_programs(name, tp):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import leaf_shapes, param_specs
    c = CONFIGS[name]
    port = get_config(c["arch"])
    assert R.n_params(c) == port.param_count(tp) == c["parameters"]
    mine = [(lf.path, R.shard_shape(lf, tp)) for lf in R.leaves(c, tp)]
    assert mine == [(p, tuple(s)) for p, s in leaf_shapes(port, tp)]
    specs = param_specs(port)
    assert {lf.path: lf.split for lf in R.leaves(c, tp)} == specs
    # matmul parameters: every leaf but the embedding and the norm scales
    # (the LM head over the published, not the padded, vocabulary)
    if tp == 1:
        skip = R.padded_vocab(c) - c["vocab"]
        n = sum(int(__import__("math").prod(lf.shape))
                for lf in R.leaves(c) if lf.init == "fan_in")
        assert FLOPS.matmul_params(c) == n - c["d_model"] * skip


@pytest.mark.parametrize("d,block", [(364_564_480, 4096),
                                     (944_570_368, 4096), (8192, 1024)])
def test_kernel_costs_are_the_programs(d, block):
    from repro_torch.perf import kernel_cost as K
    ef = _load("metrics", "kernels.ef_compress_roofline").cost(d, block)
    de = _load("metrics", "kernels.decompress_roofline").cost(d, block)
    ad = _load("metrics", "kernels.adam_step_roofline").cost(d)
    assert ef == (K.ef_compress_cost(d, block).flops,
                  K.ef_compress_cost(d, block).hbm_bytes)
    assert de == (K.decompress_cost(d, block).flops,
                  K.decompress_cost(d, block).hbm_bytes)
    fused = K.adam_update_cost(d, fused=True)
    assert ad == (fused.flops, fused.hbm_bytes)
    # by hand: x and err read, new_err written, d/8 sign bytes, a scale a
    # block; the decompress reads the payload and writes d floats; Adam
    # reads x, m, v, g and writes x, m, v
    assert ef[1] == 12 * d + d // 8 + 4 * (d // block)
    assert de[1] == 4 * d + d // 8 + 4 * (d // block)
    assert ad[1] == 28 * d


def test_peaks_are_the_data_sheets():
    from repro_torch.perf.device import get_device
    peaks = json.loads((HERE / "peaks.json").read_text())
    h100 = get_device("h100-sxm")
    assert peaks["bf16_flops"] == h100.peak_flops == 989e12
    assert peaks["hbm_bytes_per_s"] == h100.hbm_bw == 3.35e12
    assert peaks["f32_flops"] == 67e12


def test_roofline_reader_sums_bound_over_device_time():
    mod = _load("metrics", "kernels.ef_compress_roofline")
    d = 1 << 20
    run = {"peaks": json.loads((HERE / "peaks.json").read_text()),
           "traced": [{"launches": {mod.NAME: [[{"d": d, "block": 4096},
                                                1e-3]] * 2}}]}
    bound = (12 * d + d // 8 + 4 * (d // 4096)) / 3.35e12
    assert mod.read(run) == pytest.approx(100 * bound / 1e-3)
    run["traced"][0]["launches"][mod.NAME] = None
    assert mod.read(run) is None
