"""The backward of the port's bf16 model against the JAX package's, on
CPU, where it is well conditioned: the cost volume in train mode.

tests/test_torch_port_bf16_train.py holds whole bf16 train steps, whose
step-1 gradient at the tiny size is dominated by bf16 rounding noise that
train-mode BatchNorm over a few values per channel amplifies. Here the
BatchNorm of the cost volume pools thousands of values per channel, so
JAX's own bf16 gradient lies within a few percent of its float32 one, and
the port's bf16 gradient is held to twice that distance, as
tests/test_torch_port_bf16.py holds the forward modules.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu.ops import geometry as jgeo
from estdepth_tpu_torch.utils.convert import grads_from_jax
from test_torch_port_common import (  # noqa: F401
    DMAX, DMIN, H, ND, W, bf16_models, one_torch_thread, scene_arrays,
    training_test_env,
)

pytestmark = pytest.mark.usefixtures("training_test_env")
BF16 = jnp.bfloat16


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


def _max(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def test_cost_volume_bf16_backward_matches_jax():
    """The backward of the cost volume in train mode (BatchNorm on the
    batch's statistics, pooled over the pairs): a cotangent on the bf16
    volume back to the bf16 matching features (the plane sweep's gradient,
    autograd of its plain version on a bf16 map) and to pre0, pre1 and
    pre2's float32 parameters (the mixed-dtype BatchNorm backward, the
    bf16 convolutions' weight gradients). Port bf16 against JAX bf16
    within twice JAX's own bf16-against-float32 distance: the features'
    gradient in max |.| (measured ratio 0.89) and each parameter's in norm
    (measured 0.96 to 1.03; JAX's own distance is 1.3% to 10% of the
    tensor's norm, so a wrong BatchNorm term would show)."""
    jm, jm32, variables, tm = bf16_models(views=3)
    imgs, poses, intr = scene_arrays(3)
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(1, 3, H // 4, W // 4, 32)).astype(np.float32)
    feats = np.asarray(jnp.asarray(feats, BF16).astype(jnp.float32))
    ct = rng.normal(size=(1, 1, ND, H // 4, W // 4, 32)).astype(np.float32)
    ct = np.asarray(jnp.asarray(ct, BF16).astype(jnp.float32))
    k4 = np.asarray(jgeo.scale_intrinsics(intr[None], 0.25))
    dv = np.linspace(DMIN, DMAX, ND, dtype=np.float32)[None]

    def jax_grads(model, dt):
        def cost(f, params):
            out, _ = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                f, jnp.asarray(poses[None]), jnp.asarray(k4),
                jnp.asarray(dv), True, mutable=["batch_stats"],
                method=lambda m, *a: m._cost_volumes(*a))
            return out
        out, vjp = jax.vjp(cost, jnp.asarray(feats, dt), variables["params"])
        g_feats, g_params = vjp(jnp.asarray(ct, out.dtype))
        return np.asarray(g_feats, np.float32), grads_from_jax(g_params)

    want, want32 = jax_grads(jm, BF16), jax_grads(jm32, jnp.float32)
    src = _t(feats, torch.bfloat16).requires_grad_()
    with tm._mode(True):
        out = tm._cost_volumes(src, _t(poses[None]), _t(k4), _t(dv))
    out.backward(_t(ct, torch.bfloat16).permute(0, 1, 5, 2, 3, 4))
    grads = {k: p.grad for k, p in tm.named_parameters()
             if p.grad is not None}
    assert src.grad.dtype == torch.bfloat16
    own = _max(want[0], want32[0])
    assert own > 0
    assert _max(src.grad.float(), want[0]) <= 2 * own
    assert sorted(grads) == sorted(k for k in want[1] if
                                   k.startswith(("pre0", "pre1", "pre2")))
    for k, g in grads.items():
        assert g.dtype == torch.float32
        own = float((want[1][k] - want32[1][k]).norm())
        assert own > 0, k
        assert float((g - want[1][k]).norm()) <= 2 * own, k
