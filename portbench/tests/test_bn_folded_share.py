"""The reader of `bn_folded_share.mvs`: its share on hand-set counters,
None where the port has neither counter (a port before the fold) or the
run is not CasMVSNet's, and 100 in a traced CPU run of the cell
`casmvsnet.dtu_views` at the tiny size of `test_casmvsnet.py`."""

from __future__ import annotations

import pytest

from portbench.tests.test_casmvsnet import CELL, root  # noqa: F401
from portbench.tests.test_program_spans import reader, readings

METRIC = "bn_folded_share.mvs"


@pytest.mark.parametrize("counted, want", [
    ({"layers.bn_folded": 38}, 100.0),
    ({"layers.bn_folded": 30, "layers.bn_unfolded": 10}, 75.0),
    ({"layers.bn_unfolded": 38}, 0.0),
    ({"mvs.targets": 3}, None)])
def test_bn_folded_share_reads_the_counters(monkeypatch, counted, want):
    from estdepth_tpu_torch.utils import trace as port_trace

    monkeypatch.setattr(port_trace, "counts", lambda: dict(counted))
    r = readings("mvs_views", [], [1])
    assert reader(METRIC).read(r) == want
    r.protocol = "joint_window"
    assert reader(METRIC).read(r) is None


def test_traced_cpu_run_reads_every_block_folded(root, run_cell):  # noqa: F811
    res = run_cell(root, CELL, trace=1)
    assert res["correct"] is True, res["checked"]
    assert res["metrics"][METRIC]["value"] == 100.0
