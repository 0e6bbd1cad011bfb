"""Build the port's CUDA sources at first use and load them with ctypes.

Each `estdepth_tpu_torch/csrc/<name>.cu` exposes a plain C interface and is
compiled on its own by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so <name>.cu

into `build/kernels/` at the root of the checkout. The file name carries a
hash of the source, of every header in `csrc/` (`*.cuh`, which a source
may include) and of the flags, so an edited source or header is rebuilt
and a stale library is never loaded. `build_all()` starts one nvcc per source at once.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "kernels"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of estdepth_tpu_torch need the CUDA toolkit to build"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (process, temporary output, final path) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> list[str]:
    """Compile every csrc/*.cu in parallel (one nvcc each); returns the
    names built. Raises on the first failure after all have finished."""
    jobs = {name: _start(name) for name in sources()}
    errors = []
    for name, job in jobs.items():
        if job is None:
            continue
        try:
            _finish(name, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return [name for name, job in jobs.items() if job is not None]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


# the element types a kernel has an instance for, and their symbols' suffix
INSTANCES = {torch.float32: "f32", torch.bfloat16: "bf16"}
VECTOR_BYTES = 16  # a kernel's loads and stores: float4, or 8 bfloat16


class Kernel:
    """The C entry points of csrc/<source>.cu, one per element type
    (`<stem>_f32`, `<stem>_bf16`: one templated body, two instances), and
    their counts of launches.

    `argtypes` are set before an entry point's first call: without them
    ctypes passes a pointer as a 32-bit int and cuts it. The entry point
    returns cudaGetLastError() after its launch; a non-zero code raises.
    `launches` grows by one for every launch that returned 0, of either
    instance, and `launches_bf16` for those of the bfloat16 instance."""

    def __init__(self, source: str, stem: str, argtypes: list):
        self.source = source
        self.stem = stem
        self.argtypes = argtypes
        self.launches = 0
        self.launches_bf16 = 0
        self._fns = {}

    def symbol(self, dtype: torch.dtype) -> str:
        return f"{self.stem}_{INSTANCES[dtype]}"

    def __call__(self, dtype: torch.dtype, *args) -> None:
        """Launch the instance for `dtype` (float32 or bfloat16)."""
        fn = self._fns.get(dtype)
        if fn is None:
            fn = getattr(load(self.source), self.symbol(dtype))
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fns[dtype] = fn
        status = fn(*args)
        if status != 0:
            raise RuntimeError(f"{self.symbol(dtype)}: CUDA error {status}")
        self.launches += 1
        if dtype == torch.bfloat16:
            self.launches_bf16 += 1


def output_grid(name: str, x: torch.Tensor, height: int, width: int,
                planes: int | None = None) -> tuple[int, int, int]:
    """The output grid (D, H, Wo) that a warp's coordinates name, for a
    source grid of `height` x `width`: x [B, D, H, Wo] names Wo output
    columns (a width shard's own, parallel/spatial.py), x [B, D*H*W] the
    source grid's own D planes. `planes` is D where the source fixes it
    (a frustum volume's planes), else the 2-D form must be a multiple of
    H*W. Raises for any other shape."""
    if x.dim() == 4 and x.shape[2] == height and (
            planes is None or x.shape[1] == planes):
        return tuple(x.shape[1:])
    if x.dim() == 2 and x.shape[1] % (height * width) == 0 and (
            planes is None or x.shape[1] == planes * height * width):
        return x.shape[1] // (height * width), height, width
    grid = "D*H*W" if planes is None else f"{planes}*{height}*{width}"
    raise ValueError(f"{name}: coordinates {tuple(x.shape)} for a "
                     f"{height}x{width} source: [B, {grid}] or "
                     f"[B, D, {height}, Wo]")


def require_channels(name: str, shape, dtype: torch.dtype) -> None:
    """Raise unless a voxel's C channels of `dtype` are whole 16-byte
    vectors: C % 4 == 0 in float32, C % 8 == 0 in bfloat16."""
    per = VECTOR_BYTES // dtype.itemsize
    if shape[-1] % per:
        raise ValueError(f"{name}: {tuple(shape)} in {dtype}, the kernel "
                         f"takes C % {per} == 0")


def _require_basics(t: torch.Tensor, name: str, shape,
                    device: torch.device, allow_grad: bool = False,
                    dtype: torch.dtype | None = None) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: {t.dtype}, expected {dtype}")
    if t.dtype not in INSTANCES:
        raise TypeError(f"{name}: {t.dtype}; the kernels take float32 or "
                        f"bfloat16")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.requires_grad and not allow_grad:
        raise ValueError(f"{name}: requires grad; the kernel has no "
                         f"gradient for this argument (detach it, or run "
                         f"under torch.inference_mode())")


def require(t: torch.Tensor, name: str, shape, device: torch.device,
            allow_grad: bool = False,
            dtype: torch.dtype | None = None) -> None:
    """Raise unless t is a contiguous tensor of `shape` on `device` in
    `dtype`, or, with no `dtype`, in float32 or bfloat16 (a sampled volume:
    the element types the kernels have instances for): the kernels take
    nothing else. Only the sampled volume of a warp may require grad
    (`allow_grad`): `sample_with_plain_grad` gives it one."""
    _require_basics(t, name, shape, device, allow_grad, dtype)
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def require_voxel_rows(t: torch.Tensor, name: str, shape,
                       device: torch.device,
                       dtype: torch.dtype | None = None
                       ) -> tuple[list[int], int]:
    """The strided form of `require`, for a float32 or bfloat16 (or
    `dtype`) view [*lead, D, H, W, C] whose voxels are rows of C adjacent
    elements at one pitch: the channel stride is 1 and (D, H, W) collapse
    to a voxel index with stride `pitch` >= C, as in a channel slice of a
    wider contiguous volume. The leading dims may have any stride. Rows
    must be 16-byte aligned for the kernels' 16-byte loads: the pitch, the
    leading strides and the address in bytes. Returns (leading strides,
    pitch) in elements, or raises."""
    _require_basics(t, name, shape, device, dtype=dtype)
    *lead, d, h, w, c = shape
    strides = t.stride()
    if c > 1 and strides[-1] != 1:
        raise ValueError(f"{name}: channel stride {strides[-1]}, the "
                         f"kernel reads a voxel's channels as adjacent "
                         f"elements")
    pitch = None
    for size, stride, per in zip((d, h, w), strides[-4:-1], (h * w, w, 1)):
        if size == 1:
            continue
        if stride % per or (pitch is not None and stride // per != pitch):
            raise ValueError(f"{name}: strides {tuple(strides)} do not "
                             f"address (D, H, W) as one voxel index")
        pitch = stride // per
    pitch = c if pitch is None else pitch
    lead_strides = [0 if n == 1 else s
                    for n, s in zip(lead, strides[:len(lead)])]
    size = t.element_size()
    if pitch < c or any(s * size % VECTOR_BYTES
                        for s in (pitch, *lead_strides)) or (
            t.data_ptr() % VECTOR_BYTES):
        raise ValueError(f"{name}: rows of {c} {t.dtype} at pitch {pitch}, "
                         f"strides {tuple(strides)}: not 16-byte aligned "
                         f"rows")
    return lead_strides, pitch


class _PlainGrad(torch.autograd.Function):
    """forward: `launch(volume, *coords)`; backward: the gradient of
    `plain(volume, *coords)` with respect to `volume`, `None` for the rest."""

    @staticmethod
    def forward(ctx, launch, plain, name, volume, *coords):
        ctx.plain, ctx.name = plain, name
        ctx.save_for_backward(volume, *coords)
        return launch(volume, *(c.detach() for c in coords))

    @staticmethod
    def backward(ctx, grad_out):
        volume, *coords = ctx.saved_tensors
        with torch.autograd.profiler.record_function(
                f"estdepth::{ctx.name}_backward"), torch.enable_grad():
            leaf = volume.detach().requires_grad_()
            out = ctx.plain(leaf, *(c.detach() for c in coords))
            (grad,) = torch.autograd.grad(out, leaf, grad_out.contiguous())
        return (None, None, None, grad) + (None,) * len(coords)


def sample_with_plain_grad(launch, plain, name: str, volume: torch.Tensor,
                           *coords: torch.Tensor) -> torch.Tensor:
    """`launch(volume, *coords)` with the gradient the JAX package's
    `custom_vjp`s give its TPU kernels: the kernel is forward-only, and the
    backward is autograd of the plain version `plain(volume, *coords)` with
    respect to the sampled volume at the same coordinates. The coordinate
    tensors get no gradient (the reference computes its sampling grids
    under `torch.no_grad()`). Without a tensor that requires grad this is
    `launch` itself."""
    if not (torch.is_grad_enabled() and volume.requires_grad):
        return launch(volume, *(c.detach() for c in coords))
    return _PlainGrad.apply(launch, plain, name, volume, *coords)
