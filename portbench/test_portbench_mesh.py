"""The comparison on the four-card cell's 2 x 2 mesh, run through the
harness over four gloo ranks on the CPU at a small width: the program's
tensor-parallel shards and dp exchange against the reference's own
layout, and the control and the faults (the exchange left out among
them) failing the cell's limits."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

from portbench import harness  # noqa: E402
from portbench.test_portbench_check import (  # noqa: E402
    _fails, check, small_cell)


def test_four_rank_cell_control_and_faults():
    """The 2 x 2 mesh over gloo: the program's tensor-parallel shards and
    dp exchange against the reference's own layout."""
    cell = small_cell("internlm2-1.8b.onebit.dp2tp2")
    row = harness.run_job({"mode": "calibrate", "cell": cell,
                           "device": "cpu", "seeds": [5]})["rows"][0]
    limits = cell["limits"]
    assert check.verdict(row["sound"], limits)[0], row["sound"]
    for fault in ("control", "half_batch", "no_exchange"):
        assert _fails(row[fault], limits), (fault, row[fault])
