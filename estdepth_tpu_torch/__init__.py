"""estdepth_tpu_torch — the PyTorch/CUDA port of estdepth_tpu for NVIDIA Hopper.

The eval protocols of the JAX package (ESTM streaming, Joint windows, the
offline whole-scene processors), rebuilt on PyTorch with hand-written CUDA
kernels for the plane-sweep warp, the exact-z and plane-mix frustum warps
and the epipolar attention (ops/cuda/, csrc/). It
imports nothing of JAX or of `estdepth_tpu`; the JAX package is the
numerical reference the tests hold it against.

Public layouts follow the JAX package (channels-last):
  * images:        [B, V, H, W, 3] (0..255, float or uint8)
  * warp volumes:  [B, D, H, W, C]
  * ESTM memory:   [B, M, D, H, W, C]
  * camera poses:  [B, 4, 4] cam-to-world; intrinsics [B, 3, 3]
Convolutions run NCHW / NCDHW inside the modules.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; with no GPU present they raise instead of falling back.
"""

__version__ = "0.1.0"
