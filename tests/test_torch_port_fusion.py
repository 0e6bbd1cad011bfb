"""The port's epipolar attention and batched EST fusion against the JAX
package on CPU.

The attention's plain version is held against the JAX Pallas function run
in interpret mode (as tests/test_pallas.py runs it) and against its jnp
reference, at that test's tolerance: rtol 1e-5 / atol 1e-6 (the two sum
the 16 channels and the softmax in different orders). On CPU tensors the
kernel wrapper runs the plain version, also on the strided views the
fusion hands it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu.models import ESTMemory as JaxMemory
from estdepth_tpu.models.est_transformer import EpipolarTransformer as JaxEST
from estdepth_tpu.ops.pallas.epipolar_attention import (
    epipolar_attention as jax_attention,
    epipolar_attention_reference as jax_attention_reference,
)
from estdepth_tpu_torch.models.est_transformer import EpipolarTransformer
from estdepth_tpu_torch.models.memory import ESTMemory
from estdepth_tpu_torch.ops.cuda.epipolar_attention import (
    epipolar_attention, epipolar_attention_plain,
)
from estdepth_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_common import (
    H, ND, W, model_pair, random_variables, scene_arrays,
)
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _attention_case(n, s, p, none_valid=None, c=16, seed=0):
    rng = np.random.default_rng(seed)
    tk = rng.normal(size=(s, p, c)).astype(np.float32)
    wk = rng.normal(size=(n, s, p, c)).astype(np.float32)
    wv = rng.normal(size=(n, s, p, c)).astype(np.float32)
    valid = rng.uniform(size=(n, s)) > 0.3
    valid[:, 0] = True  # at least one fully valid column
    if none_valid is not None:
        valid[:, none_valid] = False
    return tk, wk, wv, valid


CASES = {"four_neighbours": dict(n=4, s=6, p=256),
         "all_invalid_slot": dict(n=4, s=6, p=256, none_valid=2),
         "two_neighbours": dict(n=2, s=3, p=128),
         "joint_three": dict(n=3, s=8, p=320)}


@pytest.mark.parametrize("reference", ["pallas_interpret", "jnp"])
@pytest.mark.parametrize("case", list(CASES))
def test_attention_plain_matches_jax(case, reference):
    args = _attention_case(**CASES[case])
    if reference == "jnp":
        want = jax_attention_reference(*map(jnp.asarray, args))
    else:
        want = jax_attention(*map(jnp.asarray, args), interpret=True)
    got = epipolar_attention_plain(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    slot = CASES[case].get("none_valid")
    if slot is not None:  # no valid neighbour: exactly 0, not NaN
        assert np.abs(got[slot]).max() == 0.0


def test_attention_wrapper_on_cpu_reads_strided_views():
    """The layout the fusion hands over: K and V halves of one warped
    [B, N, D, H, W, 2C] volume, neighbour axis moved to the front."""
    rng = np.random.default_rng(1)
    b, n, d, h, w, c = 2, 3, 4, 5, 6, 16
    warped = torch.from_numpy(
        rng.normal(size=(b, n, d, h, w, 2 * c)).astype(np.float32))
    tk = torch.from_numpy(rng.normal(size=(b, d, h, w, c)).astype(np.float32))
    valid = torch.tensor([[True, False], [True, True], [False, True]])
    view = warped.transpose(0, 1)
    wk, wv = view[..., :c], view[..., c:]
    assert not wk.is_contiguous()
    got = epipolar_attention(tk, wk, wv, valid)
    want = epipolar_attention_plain(
        tk.reshape(b * d, h * w, c),
        wk.reshape(n, b * d, h * w, c), wv.reshape(n, b * d, h * w, c),
        valid.repeat_interleave(d, 1))  # the JAX module's [S, P] folding
    np.testing.assert_array_equal(got.reshape(b * d, h * w, c).numpy(),
                                  want.numpy())


def _transformer_pair(c, seed, inputs, **jax_kwargs):
    jmod = JaxEST(c, **jax_kwargs)
    variables = random_variables(lambda: JaxEST(c).init(
        jax.random.key(0), *map(jnp.asarray, inputs)), seed=seed)
    prefix = "CostRegNet.epipolar_transformer."
    sd = {k[len(prefix):]: v for k, v in state_dict_from_jax(
        {"params": {"decoder": {"est": variables["params"]}}}).items()}
    return jmod, variables, sd


def test_transformer_fused_attention_equals_default_and_jax_pallas():
    """EpipolarTransformer(use_fused_attention=True) equals the default
    path, and both equal the JAX module with use_pallas (interpret)."""
    rng = np.random.default_rng(3)
    b, d, h, w, c, n = 1, 4, 8, 16, 16, 3
    tk, tv = (rng.normal(size=(b, d, h, w, c)).astype(np.float32)
              for _ in range(2))
    wk, wv = (rng.normal(size=(n, b, d, h, w, c)).astype(np.float32)
              for _ in range(2))
    valid = np.array([[True], [True], [False]])
    inputs = (tk, tv, wk, wv, valid)
    jmod, variables, sd = _transformer_pair(
        c, 4, inputs, use_pallas=True, pallas_interpret=True)
    want = np.asarray(jmod.apply(variables, *map(jnp.asarray, inputs)))
    outs = {}
    for fused in (False, True):
        tmod = EpipolarTransformer(c, use_fused_attention=fused)
        tmod.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            outs[fused] = tmod(*map(torch.from_numpy, inputs)).numpy()
    np.testing.assert_allclose(outs[True], outs[False], atol=1e-5, rtol=0.0)
    np.testing.assert_allclose(outs[True], want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fused_attention", [False, True])
def test_batched_est_fusion_matches_jax(fused_attention):
    """sequential_fusion=False: 3 targets and a 1-entry memory, so each
    target attends over 3 neighbours warped in one folded call."""
    jm, variables, tm = model_pair(
        views=5, jax_kwargs=dict(sequential_fusion=False),
        sequential_fusion=False, use_fused_attention=fused_attention)
    imgs, poses, intr = scene_arrays(8)
    w0 = (imgs[None, :5], poses[None, :5], intr[None])
    w1 = (imgs[None, 3:8], poses[None, 3:8], intr[None])
    _, (jk, jv, jp) = jm.apply(variables, *map(jnp.asarray, w0),
                               memory=None, use_est=False, train=False)
    jmem = JaxMemory.create(1, 1, ND, H // 4, W // 4).push(jk, jv, jp)
    want, _ = jm.apply(variables, *map(jnp.asarray, w1), memory=jmem,
                       use_est=True, train=False)
    with torch.inference_mode():
        _, (tk, tv, tp) = tm(*map(torch.from_numpy, w0), memory=None,
                             use_est=False)
        tmem = ESTMemory.create(1, 1, ND, H // 4, W // 4).push(tk, tv, tp)
        got, _ = tm(*map(torch.from_numpy, w1), memory=tmem, use_est=True)
        # the batched fusion differs from the sequential one: the test
        # would not notice a switch that does nothing otherwise
        tm.CostRegNet.sequential_fusion = True
        seq, _ = tm(*map(torch.from_numpy, w1), memory=tmem, use_est=True)
    assert got["depth"].shape == (1, 3, 4, H, W)
    for k in ("depth", "init_prob", "fused_prob"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=5e-3, rtol=0.0, err_msg=k)
    assert (got["depth"][:, 1:, :3] - seq["depth"][:, 1:, :3]).abs().max() > 1e-4
    np.testing.assert_allclose(got["depth"][:, 0].numpy(),
                               seq["depth"][:, 0].numpy(), atol=1e-5)
