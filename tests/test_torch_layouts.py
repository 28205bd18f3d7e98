"""The ``local`` and ``zero1`` state layouts over 2 gloo ranks.

One spawn of 2 ranks (its own ``file://`` rendezvous under ``tmp_path``;
``tests/_torch_layouts_worker.py``) runs the scenarios; the tests read
what each rank saved.  Everything here is bitwise: the ranks compute the
same values in the same order, and zero1 computes the replicated layout's
update on a chunk of the same vectors.

  * ``local`` (0/1 Adam, 0-bit steps between syncs): the parameters are
    bitwise equal across ranks after every step (a 0-bit step applies no
    update), while the per-rank momentum differs after a 0-bit step; a
    checkpoint of it holds each per-rank slot as (2, 1, L), rank r's in
    row r, and loads back bitwise on each rank.
  * ``zero1`` against ``replicated``, 1-bit LAMB's ``update`` over 2 ranks
    for 6 steps on the same per-rank gradients: each rank's master chunk
    is the replicated parameters' chunk, the trust ratios (segment norms
    summed over the ranks) are the replicated ones, and the gathered
    replica is the bf16 rounding of the replicated parameters.
  * step level (``bert-large-smoke``): after ``seed_zero1`` one compressed
    step under zero1 leaves the master chunks equal to the replicated
    step's parameters (the padding tail aside: the replicated step keeps
    it at zero, the zero1 master carries the optimizer's values there, as
    in the reference, and the model never reads them); the model then
    trains on its bf16 replica, equal on both ranks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp  # noqa: E402

import _torch_layouts_worker as worker  # noqa: E402

WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("layouts"))
    mp.start_processes(worker.layouts_main, args=(WORLD, workdir),
                       nprocs=WORLD, start_method="spawn")
    return [dict(np.load(f"{workdir}/rank{r}.npz")) for r in range(WORLD)]


def test_local_layout_params_equal_across_ranks(ranks):
    a, b = ranks
    syncs = list(a["local_syncs"])
    assert syncs == [True, True, True, False, True, False]
    for step in range(6):
        np.testing.assert_array_equal(a[f"local_x{step}"],
                                      b[f"local_x{step}"])
        if not syncs[step]:       # nothing applied on a 0-bit step
            np.testing.assert_array_equal(a[f"local_x{step}"],
                                          a[f"local_x{step - 1}"])
            assert not np.array_equal(a[f"local_m{step}"],
                                      b[f"local_m{step}"])
        else:                     # the synced momentum is the same
            np.testing.assert_array_equal(a[f"local_m{step}"],
                                          b[f"local_m{step}"])
    assert int(a["local_v_step"]) == 5   # refreshed at counts 3 and 5


def test_local_layout_checkpoint_across_ranks(ranks):
    a, b = ranks
    assert bool(a["ckpt_round_trip"]) and bool(b["ckpt_round_trip"])
    with np.load(str(a["ckpt_path"])) as data:
        m = data["1|.m"]
        werr = data["1|.worker_err"]
    assert m.shape == (WORLD, 1, a["local_m5"].shape[0])
    np.testing.assert_array_equal(m[0, 0], a["local_m5"])
    np.testing.assert_array_equal(m[1, 0], b["local_m5"])
    assert werr.shape[:2] == (WORLD, 1)


@pytest.mark.parametrize("i", range(6))
def test_zero1_matches_replicated_two_ranks(ranks, i):
    full = []
    for r in ranks:
        np.testing.assert_array_equal(r[f"opt_master{i}"], r[f"opt_xr{i}"])
        np.testing.assert_array_equal(r[f"opt_scale{i}"],
                                      r[f"opt_scale_r{i}"])
        full.append(r[f"opt_xr{i}"])
    x_r = torch.from_numpy(np.concatenate(full))
    for r in ranks:
        np.testing.assert_array_equal(
            r[f"opt_replica{i}"], x_r.to(torch.bfloat16).float().numpy())


def test_zero1_step_after_seed_matches_replicated(ranks):
    a, b = ranks
    chunk, d = int(a["chunk"]), int(a["d"])
    for rank, r in enumerate(ranks):
        lo = rank * chunk
        live = max(0, min(chunk, d - lo))
        assert live > 0
        np.testing.assert_array_equal(r["step_master"][:live],
                                      r["step_x_r"][lo:lo + live])
    np.testing.assert_array_equal(a["step_x_z0"], b["step_x_z0"])
    np.testing.assert_array_equal(a["step_x_z"], b["step_x_z"])
    np.testing.assert_array_equal(a["step_losses"], b["step_losses"])
    assert np.isfinite(a["step_losses"]).all()
