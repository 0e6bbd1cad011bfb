"""The bf16 slice as a whole: the port's bf16 ESTM stream and Joint chain
against the JAX package's bf16 model on CPU, and the tools' `--bf16`
paths.

Same weights (numpy from a seed, carried by the weight bridge), the same
frames (tests/test_torch_port_common.py's pitched scene): the port's
`ModelConfig(compute_dtype="bfloat16")` against JAX's
`DepthNetHybrid(dtype=jnp.bfloat16)`, all 4 depth scales, within twice
JAX's own bf16-against-float32 distance on the same frames: the two
packages agree in bf16 as well as bf16 agrees with float32. Each test
states the ratio measured here. The tools run on `--device cpu` at the
tiny size: eval_estm with --fetch-half (the scored maps fetched as
bfloat16), eval_joint, and export_serving, whose reloaded bf16 artifact
equals the live bf16 runner within 1e-5 and whose manifest says
"memory_dtype": "bfloat16".
"""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu.eval.estm import ESTMRunner as JaxRunner
from estdepth_tpu_torch import serving
from estdepth_tpu_torch.eval.estm import ESTMRunner
from estdepth_tpu_torch.tools import eval_estm, eval_joint, export_serving
from estdepth_tpu_torch.tools.eval_joint import JointRunner
from test_torch_port_common import (
    DMAX, DMIN, H, ND, W, bf16_models, pitched_frames, scene_arrays,
)
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _max(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


def _within_twice_jax_bf16(got, want_bf16, want_f32, what):
    """max |port bf16 - JAX bf16| <= 2 max |JAX bf16 - JAX float32|;
    returns the ratio of the two."""
    own = _max(want_bf16, want_f32)
    err = _max(got, want_bf16)
    assert own > 0, what
    assert err <= 2 * own, (what, err, own)
    return err / own


@pytest.fixture(scope="module")
def bf16_pair():
    return bf16_models(views=5)


def test_estm_stream_bf16_matches_jax(bf16_pair):
    """A 5-frame stream (lwindow 3, memory 2: 3 windows, the last two
    fusing the memory), all 4 depth scales: measured ratio 1.12 (0.169
    against JAX bf16's 0.152 from JAX float32)."""
    jm, jm32, variables, tm = bf16_pair
    frames = pitched_frames(5)
    runners = {"jax_bf16": JaxRunner(jm, variables, H, W),
               "jax_f32": JaxRunner(jm32, variables, H, W),
               "port": ESTMRunner(tm, H, W, device="cpu")}
    outs = {k: [] for k in runners}
    for f in frames:
        for k, r in runners.items():
            out = r.push_frame(f["img"], f["cam_pose"], f["cam_intr"])
            if out is not None:
                outs[k].append(_np(out))
    assert len(outs["port"]) == 3
    assert runners["port"].memory.keys.dtype == torch.bfloat16
    _within_twice_jax_bf16(np.stack(outs["port"]),
                           np.stack(outs["jax_bf16"]),
                           np.stack(outs["jax_f32"]), "estm stream")


def test_joint_chain_bf16_matches_jax(bf16_pair):
    """Two 5-frame Joint windows (the second fusing the first's state as a
    1-entry memory), 3 targets each, all 4 scales: measured ratio 1.14
    (0.162 against 0.142)."""
    from tools.eval_joint import JointRunner as JaxJointRunner

    jm, jm32, variables, tm = bf16_pair
    imgs, poses, intr = scene_arrays(8)
    runners = {"jax_bf16": JaxJointRunner(jm, variables, est_on=True),
               "jax_f32": JaxJointRunner(jm32, variables, est_on=True)}
    port = JointRunner(tm, device="cpu")
    outs = {k: [] for k in (*runners, "port")}
    for wi in range(2):
        sl = slice(3 * wi, 3 * wi + 5)
        window = (imgs[None, sl], poses[None, sl], intr[None])
        for k, r in runners.items():
            outs[k].append(_np(r.run_window(*map(jnp.asarray, window))[0]))
        outs["port"].append(_np(port.run_window(*window)[0]))
    assert port.memory.keys.dtype == torch.bfloat16
    _within_twice_jax_bf16(np.stack(outs["port"]),
                           np.stack(outs["jax_bf16"]),
                           np.stack(outs["jax_f32"]), "joint chain")


# ---- the tools' --bf16 paths on the CPU ---------------------------------

TINY = ["--device", "cpu", "--height", str(H), "--width", str(W),
        "--ndepths", str(ND), "--depth-min", str(DMIN), "--depth-max",
        str(DMAX), "--resnet", "18"]


def test_eval_estm_tool_bf16_fetch_half(capsys):
    """`eval_estm --synthetic --bf16 --fetch-half`: the scored maps cross
    as bfloat16 and are scored as float32 on the host; --scan gives the
    same maps."""
    argv = ["--synthetic", "--bf16", "--fetch-half", "--scenes", "1",
            "--frames", "5", *TINY]
    res = eval_estm.run(eval_estm.parse_args(argv), keep_maps=True)
    scan = eval_estm.run(eval_estm.parse_args(argv + ["--scan"]),
                         keep_maps=True)
    assert len(res["maps"]) == len(scan["maps"]) == 3
    for a, b in zip(res["maps"], scan["maps"]):
        assert a.dtype == np.float32 and a.shape == (2, H, W)
        np.testing.assert_array_equal(a, b)
        # bf16 values: the low 16 bits of each float32 are zero
        assert not (a.view(np.uint32) & 0xFFFF).any()
    assert len(res["errors"]) == 3
    eval_estm.main(argv)
    assert "inference time" in capsys.readouterr().out


def test_eval_joint_tool_bf16():
    res = eval_joint.run(eval_joint.parse_args(
        ["--synthetic", "--bf16", "--max-windows", "2", *TINY]),
        keep_maps=True)
    assert np.stack(res["maps"]).shape == (2, 3, 2, H, W)
    assert np.isfinite(np.stack(res["maps"])).all()
    assert len(res["errors"]) == 6


def test_export_serving_tool_bf16(tmp_path):
    """`export_serving --bf16 --verify 3`: the reloaded artifact equals
    the live bf16 ESTMRunner within 1e-5, its manifest says bfloat16, and
    the loaded runner carries a bfloat16 memory."""
    out = str(tmp_path / "estm")
    res = export_serving.main(["--out", out, "--bf16", "--verify", "3",
                               "--scales", "0,2", *TINY])
    assert res["max_abs_delta"] <= 1e-5
    with open(os.path.join(out, serving.MANIFEST)) as f:
        manifest = json.load(f)
    assert manifest["memory_dtype"] == "bfloat16"
    runner = serving.load_stream(out, device="cpu")
    assert runner._memory.keys.dtype == torch.bfloat16
