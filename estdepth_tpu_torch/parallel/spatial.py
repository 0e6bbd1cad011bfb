"""Width-sharded (spatially partitioned) inference over the ranks of a mesh
(port of estdepth_tpu/parallel/spatial.py).

For the latency of one stream, the image WIDTH is split over the ranks of
a `parallel.mesh.Mesh`: each rank holds its columns of the frames and of
the ESTM memory's K/V volumes, computes only its columns of every hot
tensor, and returns its columns of the outputs and of the new state. The
JAX package leaves the partitioning to XLA's GSPMD; PyTorch has none, so
every width-coupled operation of the eval forward has its cross-shard form
here and in the layers that read `current()` (ops/shard_context.py, the
context's leaf module, which the layers import without this package):

  * convolutions with a width extent above 1 and the ResNet max-pool
    (models/layers.py) exchange halo columns with their neighbours, zeros
    (the max-pool: -inf) past the image's edges;
  * GroupNorm (models/layers.py) all-reduces per-sample sums: the mean
    first, then the centred second moment; the SE gates of the SENet
    matching encoder (models/senet.py) all-reduce their per-channel sums;
  * the PSM pyramid (models/psm.py) all-reduces its window sums, runs the
    branches on the replicated pooled maps and resizes back to this rank's
    columns only;
  * the plane-sweep and frustum warps (ops/warp.py) gather the sampled
    maps or volumes whole, since a sample lands anywhere in a row, and
    compute the coordinates (the two-pass sweep's line coefficients too)
    and the kernels' output of this rank's columns only;
  * everything else of the eval forward (eval-mode BatchNorm, nearest
    upsampling, the softargmin over planes, the per-voxel attention) is
    local once the shards of every scale are aligned.

Shard boundaries fall on the stride-32 grid, the coarsest ResNet scale:
rank r of S owns the full-resolution columns
[32 floor(r W32 / S), 32 floor((r + 1) W32 / S)) with W32 = W / 32, so
each scale's shard is a whole number of columns, a stride-2 convolution
starts on an even column, and the U-Net's upsampling and skip
concatenations stay aligned without an exchange. At most W / 32 ranks
(10 at 320 px); GSPMD, which pads uneven shards, has no such limit.

The collectives are `all_gather` and `all_reduce` on the mesh's group,
which gloo runs on CUDA tensors as well as on CPU ones (two ranks on one
card). Nothing is differentiable: the JAX function is eval only.

    mesh = create_mesh(device=init_distributed(...))
    fn = make_spatial_window_fn(model, mesh, with_memory=True)
    outputs, (key, value, pose) = fn(imgs_r, poses, intr, memory_r)
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from estdepth_tpu_torch.ops.shard_context import current, width_sharded
from estdepth_tpu_torch.parallel.mesh import Mesh

GRID = 32  # full-resolution columns of a column at the coarsest scale

__all__ = ["CollectiveStats", "GRID", "WidthShards", "current",
           "make_spatial_window_fn", "shard_bounds", "width_sharded"]


@dataclasses.dataclass
class CollectiveStats:
    """What a rank's collectives moved since the last `reset`: calls by kind
    ("halo", "gather", "all_reduce") and the bytes of each kind's result
    buffers (an all_gather's: every rank's contribution)."""

    calls: dict = dataclasses.field(default_factory=dict)
    bytes: dict = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()

    def add(self, kind: str, nbytes: int) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes


def shard_bounds(width: int, size: int) -> list[tuple[int, int]]:
    """Each of `size` ranks' [start, stop) full-resolution columns of an
    image `width` columns wide, on the stride-GRID grid; raises where the
    grid has fewer columns than ranks."""
    cells = width // GRID
    if width % GRID or cells < 1:
        raise ValueError(f"width {width}: width sharding needs a multiple "
                         f"of {GRID} columns")
    if size > cells:
        raise ValueError(f"{size} ranks over {width} columns: shards fall "
                         f"on the stride-{GRID} grid, so at most {cells} "
                         f"ranks")
    return [(GRID * (r * cells // size), GRID * ((r + 1) * cells // size))
            for r in range(size)]


class WidthShards:
    """The width layout of an image `width` columns wide over `mesh`, and
    the collectives across it. A tensor's width axis is named by `dim`
    (the port mixes NCHW, NCDHW and channels-last layouts); its scale is
    read from its width, which must be this rank's shard (or, for
    `shard_width`, the whole image) at one of the model's scales."""

    def __init__(self, mesh: Mesh, width: int,
                 stats: CollectiveStats | None = None):
        self.mesh = mesh
        self.width = width
        self.bounds = shard_bounds(width, mesh.size)
        self.stats = CollectiveStats() if stats is None else stats

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def size(self) -> int:
        return self.mesh.size

    def _scale(self, local_width: int) -> int:
        """Full-resolution columns per column of this rank's shard of
        `local_width` columns."""
        lo, hi = self.bounds[self.rank]
        if local_width < 1 or (hi - lo) % local_width:
            raise ValueError(f"width {local_width} is not rank "
                             f"{self.rank}'s shard ({hi - lo} columns at "
                             f"full resolution) at any scale")
        return (hi - lo) // local_width

    def columns(self, local_width: int) -> tuple[int, int]:
        """This rank's [start, stop) columns at the scale of its shard of
        `local_width` columns."""
        s = self._scale(local_width)
        lo, hi = self.bounds[self.rank]
        return lo // s, hi // s

    def full_width(self, local_width: int) -> int:
        """The image's width at the scale of this rank's shard of
        `local_width` columns."""
        return self.width // self._scale(local_width)

    def shard_width(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's columns of a whole tensor (a view)."""
        n = x.shape[dim]
        if n < 1 or self.width % n or (self.width // n) > GRID:
            raise ValueError(f"width {n} is not the image's {self.width} "
                             f"at any scale")
        s = self.width // n
        lo, hi = self.bounds[self.rank]
        return x.narrow(dim, lo // s, (hi - lo) // s)

    # -- collectives ------------------------------------------------------

    def _all_gather(self, kind: str, x: torch.Tensor) -> list[torch.Tensor]:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self.stats.add(kind, x.numel() * x.element_size() * self.size)
        dist.all_gather(parts, x, group=self.mesh.group)
        return parts

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of `x` over the ranks (a new tensor)."""
        x = x.clone(memory_format=torch.contiguous_format)
        if self.size > 1:
            self.stats.add("all_reduce", x.numel() * x.element_size())
            dist.all_reduce(x, group=self.mesh.group)
        return x

    def gather_width(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor from every rank's shard along `dim` (one
        all_gather; uneven shards are padded to the widest and cut)."""
        if self.size == 1:
            return x
        dim = dim % x.dim()
        s = self._scale(x.shape[dim])
        widths = [(hi - lo) // s for lo, hi in self.bounds]
        pad = max(widths) - x.shape[dim]
        if pad:
            x = torch.cat([x, x.new_zeros(
                x.shape[:dim] + (pad,) + x.shape[dim + 1:])], dim)
        parts = self._all_gather("gather", x)
        return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, widths)],
                         dim)

    def halo(self, x: torch.Tensor, dim: int, left: int, right: int,
             value: float = 0.0) -> torch.Tensor:
        """`x` widened along `dim` by the `left` columns of the rank to its
        left and the `right` columns of the rank to its right, `value`
        past the image's edges. One all_gather of every rank's outermost
        max(left, right) columns on each side; a neighbour must be at
        least that wide."""
        k = max(left, right)
        if k == 0:
            return x
        dim = dim % x.dim()
        w = x.shape[dim]
        if k > w:
            raise ValueError(f"a halo of {k} columns from shards of {w}")

        def edge(n):
            return x.new_full(x.shape[:dim] + (n,) + x.shape[dim + 1:],
                              value)

        if self.size == 1:
            parts = None
        else:
            parts = self._all_gather(
                "halo", torch.cat([x.narrow(dim, 0, k),
                                   x.narrow(dim, w - k, k)], dim))
        pieces = []
        if left:
            pieces.append(edge(left) if self.rank == 0 else
                          parts[self.rank - 1].narrow(dim, 2 * k - left,
                                                      left))
        pieces.append(x)
        if right:
            pieces.append(edge(right) if self.rank == self.size - 1 else
                          parts[self.rank + 1].narrow(dim, 0, right))
        return torch.cat(pieces, dim)


def make_spatial_window_fn(model, mesh: Mesh, axis_name: str = "data",
                           with_memory: bool = False):
    """fn(imgs, poses, intr[, memory]) -> (outputs, (key, value, pose)):
    the eval forward of `model` (a DepthNetHybrid, moved to the mesh's
    device) width-sharded over `mesh`.

    imgs: this rank's columns [B, V, H, W_r, 3] of the frames; poses
    [B, V, 4, 4] and intr [B, 3, 3] whole on every rank; memory (with
    `with_memory`) an ESTMemory whose keys and values are this rank's
    [B, M, D, H/4, W_r/4, C], poses and valid whole. The outputs are this
    rank's columns: "depth" [B, T, 4, H, W_r], "init_prob" and
    "fused_prob" [B, T, H, W_r]; key and value [B, D, H/4, W_r/4, C].
    EST fusion runs when a memory is given (`use_est=memory is not None`,
    `train=False`), as the JAX function's. Every rank calls fn together.
    The layout is found from the ranks' widths at the first call of each
    width (one all_gather); `fn.stats` counts the collectives of every
    call."""
    if axis_name not in mesh.axis_names:
        raise ValueError(f"axis {axis_name!r} is not one of the mesh's "
                         f"{mesh.axis_names}")
    model = model.to(mesh.device)
    layouts: dict[int, WidthShards] = {}
    stats = CollectiveStats()

    def layout(local_width: int) -> WidthShards:
        shards = layouts.get(local_width)
        if shards is None:
            mine = torch.tensor([local_width], device=mesh.device)
            widths = [torch.empty_like(mine) for _ in range(mesh.size)]
            if mesh.size > 1:
                dist.all_gather(widths, mine, group=mesh.group)
            else:
                widths = [mine]
            widths = [int(w) for w in widths]
            shards = WidthShards(mesh, sum(widths), stats)
            want = [hi - lo for lo, hi in shards.bounds]
            if widths != want:
                raise ValueError(f"the ranks' widths {widths}: the layout "
                                 f"of {shards.width} columns over "
                                 f"{mesh.size} ranks is {want}")
            layouts[local_width] = shards
        return shards

    def fn(imgs, poses, intr, memory=None):
        if (memory is not None) != with_memory:
            raise TypeError(f"made with with_memory={with_memory}, called "
                            f"{'with' if memory is not None else 'without'}"
                            f" a memory")
        dev = mesh.device
        imgs, poses, intr = (torch.as_tensor(t).to(dev)
                             for t in (imgs, poses, intr))
        if memory is not None:
            memory = type(memory)(*(t.to(dev) for t in (
                memory.keys, memory.values, memory.poses, memory.valid)))
        with torch.inference_mode(), width_sharded(layout(imgs.shape[3])):
            return model(imgs, poses, intr, memory=memory,
                         use_est=memory is not None, train=False)

    fn.stats = stats
    return fn
