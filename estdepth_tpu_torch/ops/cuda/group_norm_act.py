"""GroupNorm followed by an activation, csrc/group_norm_act.cu.

Replaces no TPU kernel: the JAX package leaves its GroupNorms to XLA.
`group_norm_act` calls the op `estdepth::group_norm_act`
(ops/cuda/library.py): on CUDA tensors it launches the kernel, on CPU
tensors it runs `group_norm_act_plain`, what the EST GRU computed before
the kernel: `models/layers.GroupNorm` (float32 statistics and affine map,
rounded to x's type), then `torch.sigmoid` or `torch.tanh` (float32 on
the rounded value, rounded once).

ATen's CUDA group norm reduces each (sample, group) in one block: at the
GRU's [1, 16, 64, 64, 80] volumes one SM walks 5.24 M values while the
card idles. The kernel's two passes spread each group over the whole card
(`_grid`: a few blocks an SM in all) and read x once more from L2; its
float32 sums run in another order than ATen's, so on the card it is
within a few ulps of the plain version, not bit for bit. Float32 and
bfloat16; no gradient (the GRU calls it only with grad off).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from estdepth_tpu_torch.ops.cuda import build, library

# the kernel's activations, by name: its `act` argument
ACTIVATIONS = {"none": 0, "sigmoid": 1, "tanh": 2}
THREADS = 256  # a block's threads (csrc kThreads)
UNROLL = 4  # vectors a thread loads at a time (csrc kUnroll)
BLOCKS_PER_SM = 4  # the grid of a pass, over all rows
MAX_ROWS = 65535  # N * groups: the grid's second axis

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = build.Kernel("group_norm_act", "group_norm_act",
                      [_P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _I,
                       ctypes.c_float, _I, _P])


def _activate(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "sigmoid":
        return torch.sigmoid(y)
    if act == "tanh":
        return torch.tanh(y)
    return y


def group_norm_act_plain(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, groups: int, eps: float,
                         act: str) -> torch.Tensor:
    """x [N, C, *S]; weight, bias float32 [C] -> act(GroupNorm(groups)(x))
    in x's shape and type: the statistics and the affine map in float32,
    rounded to x's type, then the activation ("sigmoid", "tanh" or
    "none")."""
    return _activate(F.group_norm(x.float(), groups, weight, bias,
                                  eps).to(x.dtype), act)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           groups: int, act: str) -> None:
    """Raise unless the kernel takes the call: x [N, C, *S] contiguous
    float32 or bfloat16, C % groups == 0, N * groups <= 65535, weight and
    bias contiguous float32 [C] on x's device, a known activation."""
    if x.dim() < 2:
        raise ValueError(f"group_norm_act: x {tuple(x.shape)}, expected "
                         f"[N, C, *S]")
    n, c = x.shape[:2]
    build.require(x, "group_norm_act: x", x.shape, x.device)
    if groups < 1 or c % groups:
        raise ValueError(f"group_norm_act: {c} channels in {groups} groups")
    if n * groups > MAX_ROWS:
        raise ValueError(f"group_norm_act: {n} x {groups} groups, the "
                         f"kernel takes up to {MAX_ROWS}")
    for name, t in (("weight", weight), ("bias", bias)):
        build.require(t, f"group_norm_act: {name}", (c,), x.device,
                      allow_grad=not torch.is_grad_enabled(),
                      dtype=torch.float32)
    if act not in ACTIVATIONS:
        raise ValueError(f"group_norm_act: activation {act!r}, expected one "
                         f"of {sorted(ACTIVATIONS)}")


def _grid(device: torch.device, rows: int, length: int,
          lanes: int) -> tuple[int, int]:
    """(values a block, blocks a row) for `rows` rows of `length` values:
    about BLOCKS_PER_SM blocks an SM in all, a block at least one load of
    every thread's UNROLL vectors, its values a multiple of the vector's
    `lanes`."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    least = THREADS * UNROLL * lanes
    chunks = max(1, min(BLOCKS_PER_SM * sms // rows, -(-length // least)))
    chunk = -(-length // chunks)
    chunk = -(-chunk // lanes) * lanes
    return chunk, -(-length // chunk)


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            groups: int, eps: float, act: str) -> torch.Tensor:
    _check(x, weight, bias, groups, act)
    if x.data_ptr() % build.VECTOR_BYTES:
        # the passes split rows at x's 16-byte boundaries, which must be
        # the output's too
        x = x.clone()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    n, c = x.shape[:2]
    spatial = x.numel() // (n * c)
    length = c // groups * spatial  # a row: one sample's group
    rows = n * groups
    chunk, chunks = _grid(x.device, rows, length,
                          build.VECTOR_BYTES // x.element_size())
    partials = torch.empty((rows, chunks, 4), dtype=torch.float32,
                           device=x.device)
    with torch.cuda.device(x.device):  # the C entry launches there
        KERNEL(x.dtype, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
               out.data_ptr(), partials.data_ptr(), rows, groups,
               c // groups, spatial, chunk, chunks, eps,
               ACTIVATIONS[act], torch.cuda.current_stream().cuda_stream)
    return out


def _fake(x, weight, bias, groups, eps, act):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


OP = library.define("group_norm_act", group_norm_act_plain, _launch, _fake)


def group_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float, act: str) -> torch.Tensor:
    """act(GroupNorm(groups)(x)) for x [N, C, *S] with float32 weight and
    bias [C]: the kernel on CUDA tensors, the plain version on CPU tensors.
    Both refuse what the kernel does not take (`_check`)."""
    library.check_device("group_norm_act", x)
    _check(x, weight, bias, groups, act)
    return OP(x, weight, bias, groups, eps, act)
