"""The port's claim benchmarks and quickstart on the CPU, against the JAX
package where the inputs are the same.

  * ``block_size_ablation.run(device="cpu")`` in full: the reference's
    PASS rule holds, and each block's relative compression error equals
    the reference's ``_rel_error`` on the same numpy input at rtol 1e-5
    (no randomness; the norms sum in another order);
  * ``variance_stability``'s quadratic phase in full (``mechanism_ok``,
    with the late per-segment drift of ``--segments 8``), and its system
    phase at a few steps (finite, the result's keys);
  * ``convergence.run`` at a few steps over one optimizer and both manual
    baselines (finite curves, the result dict's keys; the whole sweep,
    nine 160-step runs, runs on the card in ``chip_smoke.py``);
  * the quickstart's ``main(device="cpu")`` at a few steps.
"""
import importlib.util
import math
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import block_size_ablation as BS  # noqa: E402
from repro_torch.benchmarks import convergence as CV  # noqa: E402
from repro_torch.benchmarks import variance_stability as VS  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _reference_module(name):
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(ROOT, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_block_size_ablation_passes_and_matches_reference():
    rows = BS.run(verbose=False, device="cpu")
    assert BS.passes(rows), rows
    assert rows[4096]["bits_per_param"] < 1.04
    ref = _reference_module("block_size_ablation")
    for b in BS.BLOCKS:
        assert math.isclose(BS._rel_error(b), ref._rel_error(b),
                            rel_tol=1e-5), b
        assert rows[b]["bits_per_param"] == round(
            8 * ref.wire_bytes(ref.D, ref.CompressionConfig(block_size=b))
            / ref.D, 3)
        assert math.isfinite(rows[b]["toy_final_loss"])


def test_variance_quadratic_phase_mechanism():
    quad = VS.quadratic_phase(segments=8)
    ok_mech, _ = VS.verdicts(quad, {"freeze_step": None, "lr_warmup": 0})
    assert ok_mech, quad
    assert quad["delta"] == 33 and quad["n_segments"] == 8
    assert 0.96 <= quad["seg_drift_late_min"] <= quad["seg_drift_late_max"] \
        <= 1.04, quad


def test_variance_system_phase_few_steps():
    sys_ = VS.system_phase(steps=4, lr_warmup=2)
    assert set(sys_) == {"freeze_step", "lr_warmup", "ratio_at_freeze",
                         "ratio_last", "loss_first", "loss_last",
                         "losses_finite"}
    assert sys_["losses_finite"] and math.isfinite(sys_["loss_last"])
    assert sys_["freeze_step"] is None      # Delta = 33 steps of history


def test_convergence_run_few_steps():
    curves = {}
    res = CV.run(verbose=False, optimizers=["onebit_adam"], steps=4,
                 warmup=2, device="cpu", curves=curves)
    assert set(curves) == {"adam", "onebit_adam:onebit",
                           "onebit_adam:identity", "naive", "msgd"}
    assert all(len(c) == 4 for c in curves.values())
    assert res["finite"]
    assert set(res) == {"final_adam", "final_onebit_adam_onebit",
                        "final_onebit_adam_identity", "final_naive",
                        "final_msgd", "finite",
                        "parity_onebit_adam_identity_vs_adam",
                        "parity_onebit_adam_onebit_vs_adam", "naive_fails",
                        "ok"}
    # the warmup stage of every optimizer is BertAdam: the first two steps
    # agree bitwise across the registry runs
    assert curves["adam"][:3] == curves["onebit_adam:onebit"][:3] == \
        curves["onebit_adam:identity"][:3]


def test_quickstart_few_steps():
    from repro_torch.examples import quickstart
    hist = quickstart.main(steps=4, device="cpu", verbose=False)
    assert [h[1] for h in hist] == ["warmup"] * 4
    assert all(math.isfinite(h[2]) for h in hist)
