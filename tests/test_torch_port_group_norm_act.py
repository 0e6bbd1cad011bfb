"""The op `estdepth::group_norm_act` (ops/cuda/group_norm_act.py) and its
use in the EST GRU, on the CPU.

The op's CPU implementation is its plain version, which computes what the
GRU computed before the op: `models/layers.GroupNorm` and the activation
after it, bit for bit, in float32 and bf16. The GRU's forward on the CPU
is bit for bit its former forward (a copy is kept here). It routes its
norms through the op only for grad-free, unsharded calls on CUDA tensors:
with `Tensor.is_cuda` patched to True the CPU run takes that route (the
op's CPU implementation, two calls a forward, the same output), and
keeps the modules with grad on and under a width shard. The kernel itself
runs only on the card (`tests/test_torch_port_cuda.py`, `-m cuda`).
"""

from __future__ import annotations

import pytest
import torch

from estdepth_tpu_torch.models import est_transformer, layers
from estdepth_tpu_torch.models.est_transformer import EpipolarTransformer
from estdepth_tpu_torch.ops.cuda import build, group_norm_act
from estdepth_tpu_torch.ops.cuda.epipolar_attention import (
    epipolar_attention_plain,
)
from estdepth_tpu_torch.parallel import spatial
from estdepth_tpu_torch.parallel.mesh import Mesh
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EPS = 1e-5
ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "none": lambda y: y}


def _inputs(n: int, c: int, dtype: torch.dtype, seed: int = 0,
            spatial_shape=(4, 6, 8)):
    gen = torch.Generator().manual_seed(seed)
    x = (2.0 * torch.randn(n, c, *spatial_shape, generator=gen) + 0.5).to(
        dtype)
    weight = 1.0 + 0.2 * torch.randn(c, generator=gen)
    bias = 0.2 * torch.randn(c, generator=gen)
    return x, weight, bias


def _module(groups: int, weight: torch.Tensor,
            bias: torch.Tensor) -> layers.GroupNorm:
    norm = layers.GroupNorm(groups, weight.numel(), eps=EPS)
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
    return norm


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("groups", [1, 2])
def test_plain_version_is_the_module_and_activation(groups, act, dtype, n):
    x, weight, bias = _inputs(n, 16, dtype)
    with torch.no_grad():
        want = ACTS[act](_module(groups, weight, bias)(x))
    got = group_norm_act.group_norm_act(x, weight, bias, groups, EPS, act)
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_groups_are_the_gru_gates_two_norms(dtype, n):
    """GroupNorm(2) of the 2C gate channels is GroupNorm(1) of each half,
    bit for bit: the GRU's reset and update gates in one call."""
    x, weight, bias = _inputs(n, 32, dtype, seed=1)
    with torch.no_grad():
        want = torch.cat([
            torch.sigmoid(_module(1, weight[:16], bias[:16])(x[:, :16])),
            torch.sigmoid(_module(1, weight[16:], bias[16:])(x[:, 16:]))], 1)
    got = group_norm_act.group_norm_act(x, weight, bias, 2, EPS, "sigmoid")
    assert torch.equal(got, want)


def _former_forward(m: EpipolarTransformer, target_key, target_value,
                    warped_keys=None, warped_values=None,
                    neighbor_valid=None):
    """EpipolarTransformer.forward before the op, the plain attention
    route."""
    c = m.channels
    if warped_keys is not None and warped_keys.shape[0] > 0:
        n, b = warped_keys.shape[:2]
        if neighbor_valid is None:
            neighbor_valid = torch.ones(n, b, dtype=torch.bool)
        h = epipolar_attention_plain(target_key, warped_keys, warped_values,
                                     neighbor_valid)
    else:
        h = torch.zeros_like(target_value)
    x = target_value.permute(0, 4, 1, 2, 3)
    h = h.permute(0, 4, 1, 2, 3)
    gates = m.gate_conv(torch.cat([x, h], 1))
    r = torch.sigmoid(m.reset_gate_norm(gates[:, :c]))
    u = torch.sigmoid(m.update_gate_norm(gates[:, c:]))
    o = m.output_norm(m.output_conv(torch.cat([x, r * h], 1)))
    y = torch.tanh(o)
    out = u * h + (1.0 - u) * y
    return out.permute(0, 2, 3, 4, 1)


def _gru(dtype: torch.dtype, b: int = 1, seed: int = 0):
    """A GRU of 8 channels with trained-looking norms, and its inputs:
    target key and value [B, 3, 4, 32, 8], 2 neighbours, one invalid."""
    torch.manual_seed(seed)
    m = EpipolarTransformer(8)
    with torch.no_grad():
        for norm in (m.reset_gate_norm, m.update_gate_norm, m.output_norm):
            norm.weight.uniform_(0.5, 1.5)
            norm.bias.uniform_(-0.3, 0.3)
    gen = torch.Generator().manual_seed(seed + 1)

    def t(*shape):
        return torch.randn(*shape, generator=gen).to(dtype)

    valid = torch.ones(2, b, dtype=torch.bool)
    valid[1, 0] = False
    return m, (t(b, 3, 4, 32, 8), t(b, 3, 4, 32, 8), t(2, b, 3, 4, 32, 8),
               t(2, b, 3, 4, 32, 8), valid)


@pytest.mark.parametrize("neighbours", [True, False])
@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_on_the_cpu_is_its_former_forward(dtype, grad, neighbours):
    m, args = _gru(dtype, b=2)
    args = args if neighbours else args[:2]
    with torch.set_grad_enabled(grad):
        got, want = m(*args), _former_forward(m, *args)
    assert torch.equal(got, want)


def _count_op_calls(monkeypatch) -> list:
    calls = []

    def counted(x, weight, bias, groups, eps, act):
        calls.append((tuple(x.shape), groups, act))
        return group_norm_act.group_norm_act(x, weight, bias, groups, eps,
                                             act)

    monkeypatch.setattr(est_transformer, "group_norm_act", counted)
    monkeypatch.setattr(torch.Tensor, "is_cuda",
                        property(lambda self: True))
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_routes_grad_free_unsharded_cuda_calls_through_the_op(
        monkeypatch, dtype):
    """Tensors that say they are on CUDA, grad off: the gates' two norms
    are one call (2 groups, sigmoid), the output norm another (1 group,
    tanh); on the CPU the op is its plain version, so the output is the
    former forward's."""
    m, args = _gru(dtype)
    with torch.no_grad():
        want = _former_forward(m, *args)
        calls = _count_op_calls(monkeypatch)
        got = m(*args)
    assert calls == [((1, 16, 3, 4, 32), 2, "sigmoid"),
                     ((1, 8, 3, 4, 32), 1, "tanh")]
    assert torch.equal(got, want)


def test_gru_keeps_the_modules_with_grad_on(monkeypatch):
    m, args = _gru(torch.float32)
    calls = _count_op_calls(monkeypatch)
    with torch.enable_grad():
        out = m(*args)
        out.sum().backward()
    assert calls == [] and out.requires_grad
    assert m.output_norm.weight.grad is not None


def test_gru_keeps_the_modules_under_a_width_shard(monkeypatch):
    """Under `width_sharded` the norms take their statistics over every
    rank's columns (models/layers.GroupNorm), which the op does not: the
    modules run, here one rank's whole width."""
    m, args = _gru(torch.float32)
    with torch.no_grad():
        want = _former_forward(m, *args)
        calls = _count_op_calls(monkeypatch)
        shards = spatial.WidthShards(Mesh(None, 0, 1, torch.device("cpu")),
                                     32)
        with spatial.width_sharded(shards):
            got = m(*args)
    assert calls == []
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype, groups, act", [
    (torch.float32, 2, "sigmoid"), (torch.float32, 1, "tanh"),
    (torch.bfloat16, 3, "none")])
def test_opcheck(dtype, groups, act):
    x, weight, bias = _inputs(2, 6, dtype)
    torch.library.opcheck(group_norm_act.OP,
                          (x, weight, bias, groups, EPS, act))


def _refusals():
    x, weight, bias = _inputs(1, 16, torch.float32)
    needs_grad = weight.clone().requires_grad_()
    return {
        "float64": ((x.double(), weight, bias, 1, "tanh"), TypeError),
        "float16": ((x.half(), weight, bias, 1, "tanh"), TypeError),
        "not contiguous": ((x.transpose(2, 3), weight, bias, 1, "tanh"),
                           ValueError),
        "groups": ((x, weight, bias, 3, "tanh"), ValueError),
        "no channels": ((x[0, 0, 0, 0], weight, bias, 1, "tanh"),
                        ValueError),
        "rows": ((torch.zeros(4097, 16, 1), weight, bias, 16, "tanh"),
                 ValueError),
        "weight shape": ((x, weight[:8], bias, 1, "tanh"), ValueError),
        "bias shape": ((x, weight, bias[None], 1, "tanh"), ValueError),
        "weight dtype": ((x, weight.bfloat16(), bias, 1, "tanh"),
                         TypeError),
        "weight device": ((x, weight.to("meta"), bias, 1, "tanh"),
                          ValueError),
        "x device": ((x.to("meta"), weight, bias, 1, "tanh"), ValueError),
        "activation": ((x, weight, bias, 1, "relu"), ValueError),
        "a gradient": ((x, needs_grad, bias, 1, "tanh"), ValueError),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    (x, weight, bias, groups, act), error = _refusals()[case]
    with torch.enable_grad(), pytest.raises(error):
        group_norm_act.group_norm_act(x, weight, bias, groups, EPS, act)


class _Card:
    multi_processor_count = 132


@pytest.mark.parametrize("n, channels, groups, dtype", [
    (1, 32, 2, torch.float32), (1, 16, 1, torch.float32),
    (3, 32, 2, torch.float32), (1, 32, 2, torch.bfloat16),
    (2, 9, 3, torch.float32)])
def test_grid_covers_each_row_over_the_whole_card(monkeypatch, n, channels,
                                                  groups, dtype):
    """At the GRU's [N, C, 64, 64, 80] volumes a pass has about 4 blocks
    an SM of an H100 (132), each block's values whole 16-byte vectors,
    and the blocks of a row cover it with less than one block to spare;
    a tiny row is one block."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: _Card())
    lanes = build.VECTOR_BYTES // dtype.itemsize
    rows = n * groups
    for length in (channels // groups * 64 * 64 * 80, 35, 1):
        chunk, chunks = group_norm_act._grid(torch.device("cuda"), rows,
                                             length, lanes)
        assert chunk % lanes == 0
        assert chunk * (chunks - 1) < length <= chunk * chunks
        if length > 35:
            assert 3 * 132 < rows * chunks <= 4 * 132
        else:
            assert chunks == 1
