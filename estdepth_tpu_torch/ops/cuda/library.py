"""The eight kernels as PyTorch operators: `estdepth::*` custom ops.

On a TPU a Pallas call lowers into the StableHLO of the program that runs
it. Here a kernel is a ctypes call on raw pointers, which `torch.export`
cannot trace: on a fake tensor there is no pointer, and on a CPU tensor
the plain version would be traced as ordinary ATen ops and so be served
on the card in place of the kernel. Each kernel is therefore one
`torch.library.custom_op`:

  * its CPU implementation is the plain PyTorch version;
  * its CUDA implementation launches the kernel (`build.Kernel`), after
    the wrapper's `build.require*` checks; a failed build or launch
    raises, and a CUDA tensor never reaches the plain version;
  * its fake implementation gives the output's shape, dtype and
    contiguity, so that an exported program holds the op node itself and
    chooses the kernel when it runs, on the device it runs on.

| op                             | kernel | module                     |
|--------------------------------|--------|----------------------------|
| estdepth::plane_sweep_sample   | 1      | ops/cuda/plane_warp.py     |
| estdepth::exact_z_resample     | 2      | ops/cuda/plane_warp_exact_z.py |
| estdepth::two_pass_resample    | 3      | ops/cuda/two_pass.py       |
| estdepth::plane_mix_resample   | 4      | ops/cuda/plane_mix.py      |
| estdepth::epipolar_attention   | 5      | ops/cuda/epipolar_attention.py |
| estdepth::view_variance        | none   | ops/cuda/view_variance.py  |
| estdepth::view_correlation     | none   | ops/cuda/view_correlation.py |
| estdepth::group_norm_act       | none   | ops/cuda/group_norm_act.py |

Kernels 1-5 replace the JAX package's TPU kernels; `view_variance`,
`view_correlation` and `group_norm_act` replace none (CasMVSNet's variance
over the views and TransMVSNet's correlation of a swept view with the
reference, which the JAX package does not have, and the EST GRU's
GroupNorms and activations, which it leaves to XLA).

Each module defines its op with `define` when it is imported;
`load_ops()` imports all eight, which a loaded program needs before it is
deserialized. The ops carry no autograd formula: kernels 1-4 get theirs
from `build.sample_with_plain_grad`, and kernel 5, `view_variance`,
`view_correlation` and `group_norm_act` are forward-only.
"""

from __future__ import annotations

import importlib

import torch

NAMESPACE = "estdepth"
# op name -> the module that defines it
MODULES = {
    "plane_sweep_sample": "plane_warp",
    "exact_z_resample": "plane_warp_exact_z",
    "two_pass_resample": "two_pass",
    "plane_mix_resample": "plane_mix",
    "epipolar_attention": "epipolar_attention",
    "view_variance": "view_variance",
    "view_correlation": "view_correlation",
    "group_norm_act": "group_norm_act",
}


def define(name: str, plain, launch, fake):
    """The op `estdepth::<name>`: `plain` on CPU tensors (its annotated
    signature is the op's schema), `launch` on CUDA tensors, `fake` for
    tracing. None of them may return a view of an input."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", plain,
                                 mutates_args=(), device_types="cpu")
    op.register_kernel("cuda")(launch)
    op.register_fake(fake)
    return op


def check_device(name: str, t: torch.Tensor) -> None:
    """Raise for a tensor on neither the CPU nor a CUDA device: the op
    would run its shape function there and compute nothing."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def load_ops() -> dict:
    """Define all eight ops (importing their modules); returns
    {name: op}."""
    return {name: getattr(importlib.import_module(
        f"estdepth_tpu_torch.ops.cuda.{module}"), "OP")
        for name, module in MODULES.items()}

