"""One rank of the port's width-sharded CPU tests (no test of its own).

    PYTHONPATH=. python tests/torch_port_spatial_worker.py \
        --coordinator localhost:PORT --rank R --world S \
        --inputs inputs.pt --out DIR [--all]

Joins a gloo group of `--world` processes on the CPU and runs the cases
that tests/test_torch_port_spatial.py holds against the unsharded port and
the JAX package, each on this rank's columns of the whole inputs in
`inputs.pt`; rank 0 writes the whole results, gathered over the ranks,
to `DIR/results.pt`. Imports nothing of JAX.

Cases:
  * primitives: each layer of PRIMITIVES on this rank's columns inside
    `width_sharded` (halo convolutions, the -inf max-pool, GroupNorm,
    the SE gate, the PSM pyramid), the two-pass plane sweep
    (`plane_sweep_warp(two_pass=True)`, kernel 3 at this rank's output
    window), and shard_width / gather_width round trips;
  * the FORWARD_CASES: make_spatial_window_fn without and with a 2-entry
    memory (3-frame window) of the PSM model of `inputs["weights"]` in
    each frustum mode and with the two-pass sweep, and of the SENet
    model of `inputs["senet_weights"]`;
  * with --all also chain (3 windows of the ESTM stream, the memory
    pushed from each window's sharded state, the first window without
    EST) and bf16 (forward_memory of the bf16 model).
"""

from __future__ import annotations

import argparse
import os

import torch

from estdepth_tpu_torch.config import ModelConfig, torch_dtype
from estdepth_tpu_torch.models import layers
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.models.memory import ESTMemory
from estdepth_tpu_torch.models.psm import pyramid
from estdepth_tpu_torch.models.senet import SEModule
from estdepth_tpu_torch.ops.warp import plane_sweep_warp
from estdepth_tpu_torch.parallel.mesh import (
    create_mesh, init_distributed, shutdown,
)
from estdepth_tpu_torch.parallel.spatial import (
    WidthShards, make_spatial_window_fn, width_sharded,
)

H, W, ND, DMIN, DMAX = 64, 96, 8, 0.5, 8.0
# name -> (layer, input shape); every width is the image's at one scale
# (96 px: 1, 48: 2, 24: 4, 6: 16, 3: 32), so a layer sees one rank's
# columns at that scale
PRIMITIVES = {
    "conv2d_3x3": (lambda: layers.Conv2d(4, 5, 3, 1, 1), (2, 4, 6, 24)),
    "conv2d_3x3_stride2": (lambda: layers.Conv2d(4, 5, 3, 2, 1),
                           (2, 4, 6, 48)),
    "conv2d_3x3_dilation2": (lambda: layers.Conv2d(4, 5, 3, 1, 2, 2),
                             (2, 4, 6, 24)),
    "conv2d_7x7_stride2_stem": (lambda: layers.Conv2d(3, 5, 7, 2, 3),
                                (1, 3, 8, 96)),
    "conv2d_3x3_at_1_32": (lambda: layers.Conv2d(4, 5, 3, 1, 1),
                           (2, 4, 2, 3)),
    "conv2d_3x3_stride2_to_1_32": (lambda: layers.Conv2d(4, 5, 3, 2, 1),
                                   (2, 4, 2, 6)),
    "conv2d_1x1_stride2": (lambda: layers.Conv2d(4, 5, 1, 2, 0),
                           (2, 4, 4, 6)),
    "conv2d_3x3_grouped": (lambda: layers.Conv2d(8, 8, 3, 1, 1, groups=4),
                           (2, 8, 6, 24)),
    "conv3d_3x3x3": (lambda: layers.Conv3d(4, 5, 3, 1, 1), (2, 4, 3, 5, 24)),
    "conv3d_3x3x3_stride2": (lambda: layers.Conv3d(4, 5, 3, 2, 1),
                             (2, 4, 4, 6, 48)),
    "maxpool_3x3_stride2": (lambda: layers.MaxPool2d(3, 2, 1),
                            (2, 4, 6, 48)),
    "groupnorm_1_group": (lambda: layers.GroupNorm(1, 8, eps=1e-5),
                          (2, 8, 3, 5, 24)),
    "groupnorm_4_groups": (lambda: layers.GroupNorm(4, 8, eps=1e-5),
                           (2, 8, 5, 24)),
    "se_module": (lambda: SEModule(16, 4), (2, 16, 6, 24)),
}
# (shape, dim) of the round trips: a channels-last volume at 1/4 scale,
# an NCHW map at 1/32 and frames at full width
ROUND_TRIPS = [((2, 3, 4, 24, 5), 3), ((2, 3, 4, 3), 3), ((1, 2, 8, 96, 3), 3)]
# case -> (the ModelConfig fields of its model, whether it fuses a
# 2-entry memory with EST)
FORWARD_CASES = {
    "forward": ({}, False),
    "forward_memory": ({}, True),
    "forward_plane_mix": ({"frustum_mode": "plane_mix"}, True),
    "forward_exact": ({"frustum_mode": "exact"}, True),
    "forward_two_pass": ({"two_pass_warp": True}, True),
    "forward_senet": ({"feature_net": "senet"}, False),
    "forward_senet_memory": ({"feature_net": "senet"}, True),
}


def primitive_layer(name: str, state: dict) -> torch.nn.Module:
    layer = PRIMITIVES[name][0]()
    layer.load_state_dict(state)
    return layer


def primitives(inputs, shards):
    res = {}
    with torch.inference_mode(), width_sharded(shards):
        for name in PRIMITIVES:
            layer = primitive_layer(name, inputs["primitive_states"][name])
            x = shards.shard_width(inputs["primitive_inputs"][name], -1)
            res[name] = shards.gather_width(layer(x), -1)
        net = DepthNetHybrid(ModelConfig(
            ndepths=ND, depth_min=DMIN, depth_max=DMAX, resnet=18))
        net.load_state_dict(inputs["weights"])
        raw, skip = (shards.shard_width(inputs[k], -1)
                     for k in ("pyramid_raw", "pyramid_skip"))
        res["psm_pyramid"] = shards.gather_width(
            pyramid(net.matchingFeature, raw, skip), -1)
        sweep = inputs["two_pass_sweep"]
        feat = shards.shard_width(sweep["feat"], 2).contiguous()
        res["two_pass_sweep"] = shards.gather_width(plane_sweep_warp(
            feat, sweep["src_proj"], sweep["ref_proj"], sweep["dvals"],
            two_pass=True), 3)
    res["round_trips"] = [
        torch.equal(shards.gather_width(shards.shard_width(x, dim), dim), x)
        for x, dim in ((inputs[f"round_trip_{i}"], dim)
                       for i, (_, dim) in enumerate(ROUND_TRIPS))]
    return res


def _model(inputs, dtype="float32", **cfg):
    model = DepthNetHybrid(ModelConfig(
        ndepths=ND, depth_min=DMIN, depth_max=DMAX, resnet=18,
        compute_dtype=dtype, **cfg))
    senet = cfg.get("feature_net") == "senet"
    model.load_state_dict(inputs["senet_weights" if senet else "weights"],
                          strict=True)
    return model


def _window(inputs, shards, start):
    imgs = inputs["imgs"][:, start:start + 3]
    return (shards.shard_width(imgs, 3), inputs["poses"][:, start:start + 3],
            inputs["intr"])


def _memory_shard(inputs, shards, dtype=torch.float32):
    m = inputs["memory"]
    return ESTMemory(shards.shard_width(m["keys"], 4).to(dtype),
                     shards.shard_width(m["values"], 4).to(dtype),
                     m["poses"], m["valid"])


def forward(inputs, mesh, shards, cfg, with_memory, dtype="float32"):
    fn = make_spatial_window_fn(_model(inputs, dtype, **cfg), mesh,
                                with_memory=with_memory)
    args = _window(inputs, shards, 0)
    if with_memory:
        args += (_memory_shard(inputs, shards, torch_dtype(dtype)),)
    out, (key, value, pose) = fn(*args)
    # every output map ends in its width axis
    res = {k: shards.gather_width(v, -1) for k, v in out.items()}
    res["key"] = shards.gather_width(key, 3)
    res["value"] = shards.gather_width(value, 3)
    res["pose"] = pose
    res["calls"] = dict(fn.stats.calls)
    return res


def chain(inputs, mesh, shards, windows=3):
    """The ESTM runner's order: the first window without EST, each window's
    sharded state pushed into the sharded memory."""
    model = _model(inputs)
    plain = make_spatial_window_fn(model, mesh)
    fused = make_spatial_window_fn(model, mesh, with_memory=True)
    lo, hi = shards.bounds[shards.rank]
    memory = ESTMemory.create(1, 2, ND, H // 4, (hi - lo) // 4)
    depths = []
    for i in range(windows):
        args = _window(inputs, shards, i)
        out, state = plain(*args) if i == 0 else fused(*args, memory)
        memory = memory.push(*state)
        depths.append(shards.gather_width(out["depth"], -1))
    return {"depth": torch.stack(depths, 1)}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--inputs", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--all", action="store_true")
    args = p.parse_args()
    torch.set_num_threads(1)
    init_distributed(args.coordinator, args.world, args.rank, device="cpu")
    mesh = create_mesh()
    shards = WidthShards(mesh, W)
    inputs = torch.load(args.inputs, weights_only=True)
    res = {"primitives": primitives(inputs, shards),
           **{case: forward(inputs, mesh, shards, cfg, with_memory)
              for case, (cfg, with_memory) in FORWARD_CASES.items()}}
    if args.all:
        res["chain"] = chain(inputs, mesh, shards)
        res["bf16"] = forward(inputs, mesh, shards, {}, True, "bfloat16")
    if mesh.rank == 0:
        torch.save(res, os.path.join(args.out, "results.pt"))
    shutdown()


if __name__ == "__main__":
    main()
