"""The output check's control on the card: the reference computed with TF32
in the program's place fails each cell's limits, while a run of the
program on the same seed passes them. Every cell's configuration at its
own widths and frame size; scenes of 24 frames, so a test run holds it.

    python -m pytest portbench/tests/test_control_cuda.py -m cuda -q
"""

from __future__ import annotations

import argparse
import dataclasses

import pytest

from portbench.tests.conftest import ROOT, SEED, load_run

pytestmark = pytest.mark.cuda


def _short(cell):
    mix = dict(cell.mix, scene=dict(cell.mix["scene"], frames=24))
    return dataclasses.replace(cell, mix=mix)


@pytest.mark.parametrize("workload", ["psm.estm_stream", "psm.joint_window",
                                      "senet.joint_window", "psm.train_step"])
def test_control_fails_where_the_program_passes(cuda_device, workload):
    from portbench.calibrate import control_numbers
    from portbench.harness import cell as cells

    cell = cells.load(ROOT, workload)
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    control = control_numbers(_short(cell), SEED, cuda_device)
    assert any(control[k] > limits[k] for k in limits), control
    res = load_run().run(argparse.Namespace(workload=workload, seed=SEED,
                                            seconds=3.0, trace=0))
    assert res["correct"], res["checked"]
