"""Train DepthNetHybrid on one device (counterpart of tools/train.py).

    python -m estdepth_tpu_torch.tools.train --datapath /data/scannet \
        --split train_split.txt --pretrained-encoder resnet50.pth
    python -m estdepth_tpu_torch.tools.train --synthetic --steps 4

The reference's recipe (train_hybrid.py): Adam 4e-5 with L2 4e-4, linear
warm-up then multi-step decay, gradient clip 10 for epochs < 3 and 1 after,
5-frame windows (3 targets), batch 1, float32. The defaults are the JAX
tool's sizes (256x320, 64 planes in [0.01, 10] m, ResNet-50). The forward
runs the CUDA warp kernels (the plane sweep, and the exact-z frustum warp
of the EST fusion; --two-pass-warp sweeps through the fused two-pass
resample instead); their gradients are the plain versions'.

Data: ScanNet scenes (--datapath, data/scannet.py; colour is JPEG, read by
the native reader where it builds, else by OpenCV), or synthetic scenes
with analytic depth (--synthetic). Both go through data/pipeline.py's
TrainLoader: one permutation per epoch from the seed, decoded on
--num-workers threads and uploaded a batch ahead of the step. The encoder
can start from ImageNet weights (--pretrained-encoder: a torchvision .pth,
or the .npz of tools/import_torchvision.py). Writes scalars to
<logdir>/scalars.jsonl, colourized depth, probability and ground truth of
the batch's first window to <logdir>/images every --image-freq steps, and
checkpoints to <logdir>/ckpt; --resume continues from the latest one. Runs
on the CUDA device unless --device cpu is given.

Not here, of the JAX tool's flags: --multihost, --coordinator,
--num-processes and --process-id wait for data parallelism (DDP over NCCL);
--bf16 waits for the bf16 model; --fast-frustum, --pallas-warp and
--conv3d-as2d are TPU forms (the warp is chosen by --exact-warp and
--exact-z).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from estdepth_tpu_torch.config import (
    ModelConfig, TrainConfig, resolve_device, resolve_frustum_mode,
    set_fp32_numerics,
)
from estdepth_tpu_torch.data.pipeline import TrainLoader, prefetch_to_device
from estdepth_tpu_torch.data.scannet import ScanNetTrainDataset
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, synthetic_window,
)
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.train.schedule import warmup_multistep_schedule
from estdepth_tpu_torch.train.trainer import (
    REMAT_POLICIES, TrainState, make_optimizer, make_train_step,
)
from estdepth_tpu_torch.utils.checkpoint import (
    CheckpointManager, load_weights_for_finetune, partial_restore,
)
from estdepth_tpu_torch.utils.convert import load_pretrained_encoder
from estdepth_tpu_torch.utils.logging import DictAverageMeter, ScalarLogger
from estdepth_tpu_torch.utils.viz import (
    colorize_depth, colorize_probmap, save_image,
)

ENCODERS = ("matchingFeature", "semanticFeature")


def parse_args(argv=None):
    mc, tc = ModelConfig(), TrainConfig()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    source = p.add_mutually_exclusive_group(required=True)
    source.add_argument("--datapath", type=str, default=None,
                        help="root of ScanNet training scenes "
                             "(<scene>/{rgb,depth,pose})")
    source.add_argument("--synthetic", action="store_true",
                        help="train on generated synthetic scenes")
    p.add_argument("--split", type=str, default=None,
                   help="with --datapath: a text file of scene names "
                        "(default: every scene under --datapath)")
    p.add_argument("--num-workers", type=int, default=4,
                   help="threads that decode the next batches")
    p.add_argument("--logdir", type=str, default="./logs")
    p.add_argument("--epochs", type=int, default=tc.epochs)
    p.add_argument("--steps", type=int, default=None,
                   help="cap the total steps of this run (smoke runs)")
    p.add_argument("--lr", type=float, default=tc.lr)
    p.add_argument("--wd", type=float, default=tc.weight_decay)
    p.add_argument("--lrepochs", type=str, default="2,4,6:2",
                   help="milestones:decay-divisor (train_hybrid.py:80-82)")
    p.add_argument("--batch-per-device", type=int,
                   default=tc.batch_per_device)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--n-frames", type=int, default=5)
    p.add_argument("--ndepths", type=int, default=mc.ndepths)
    p.add_argument("--depth-min", type=float, default=mc.depth_min)
    p.add_argument("--depth-max", type=float, default=mc.depth_max)
    p.add_argument("--resnet", type=int, default=mc.resnet)
    p.add_argument("--no-est", action="store_true")
    p.add_argument("--fix-matching-feature", action="store_true",
                   help="freeze the PSM matching encoder "
                        "(train_hybrid.py:297-301)")
    p.add_argument("--fix-semantic-feature", action="store_true",
                   help="freeze the ResNet context encoder "
                        "(train_hybrid.py:302-306)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--loadckpt", type=str, default=None,
                   help="initialize weights from a checkpoint directory "
                        "written by this tool or from a reference .ckpt; "
                        "shape-filtered partial load (train_hybrid.py:"
                        "331-337). Ignored when --resume finds a checkpoint")
    p.add_argument("--restore-part", action="store_true",
                   help="with --loadckpt, restore ONLY the two encoders "
                        "(train_hybrid.py:338-347)")
    p.add_argument("--pretrained-encoder", type=str, default=None,
                   help="ImageNet-pretrained context encoder: a torchvision "
                        "resnet .pth, or the .npz of tools/"
                        "import_torchvision.py (the reference's "
                        "pretrained=True, resnet_encoder.py:35); applied "
                        "after init, before --resume / --loadckpt")
    p.add_argument("--seed", type=int, default=tc.seed)
    p.add_argument("--summary-freq", type=int, default=tc.summary_freq)
    p.add_argument("--image-freq", type=int, default=100,
                   help="write colourized depth, probability and ground "
                        "truth of the batch's first window every N steps")
    p.add_argument("--debug-nans", action="store_true",
                   help="autograd anomaly mode, on in the reference "
                        "(train_hybrid.py:167): the backward names the "
                        "operation that made a NaN; it slows every step "
                        "several-fold")
    p.add_argument("--ckpt-steps", type=int, default=tc.ckpt_steps)
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward during the backward")
    p.add_argument("--remat-policy", default="nothing",
                   choices=REMAT_POLICIES,
                   help="with --remat: what the backward keeps "
                        "(save_features keeps the encoders' outputs, so "
                        "only the cost volumes and the decoder recompute)")
    p.add_argument("--grad-accum", type=int, default=tc.grad_accum,
                   help="microbatches per step")
    p.add_argument("--exact-warp", action="store_true",
                   help="the reference's trilinear frustum warp")
    p.add_argument("--exact-z", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="exact-z correction on the plane-mix warp "
                        "(default on; --no-exact-z: plain plane-mix)")
    p.add_argument("--two-pass-warp", action="store_true",
                   help="plane sweep through the fused two-pass resample")
    p.add_argument("--sequential-cost-bn", action="store_true",
                   help="BatchNorm statistics per (target, neighbour) call "
                        "in the reference's loop order")
    p.add_argument("--device", type=str, default=None)
    return p.parse_args(argv)


class SyntheticTrainDataset:
    """Map-style wrapper over synthetic_window with varied scenes."""

    def __init__(self, n, height, width, n_frames, depth_min, depth_max):
        self.cfgs = [SyntheticSceneConfig(height=height, width=width, seed=i)
                     for i in range(max(n // 4, 1))]
        self.n = n
        self.n_frames = n_frames
        self.depth_min = depth_min
        self.depth_max = depth_max

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        w = synthetic_window(
            self.cfgs[i % len(self.cfgs)], n_frames=self.n_frames,
            start_frame=i % 7, depth_min=self.depth_min,
            depth_max=self.depth_max)
        return {k: v[0] for k, v in w.items()}  # unbatch


def make_dataset(args):
    """The map-style dataset of --datapath or --synthetic."""
    if args.synthetic:
        return SyntheticTrainDataset(256, args.height, args.width,
                                     args.n_frames, args.depth_min,
                                     args.depth_max)
    return ScanNetTrainDataset(
        args.datapath, args.split, args.height, args.width, args.n_frames,
        depth_min=max(args.depth_min, 0.1), depth_max=args.depth_max)


def build(args, device):
    """The model (with --pretrained-encoder applied), optimizer, scheduler
    and loader `args` describe: (state, loader, steps_per_epoch)."""
    loader = TrainLoader(make_dataset(args), args.batch_per_device,
                         num_workers=args.num_workers, seed=args.seed)
    steps_per_epoch = max(loader.steps_per_epoch(), 1)
    milestones, decay = args.lrepochs.split(":")
    schedule = warmup_multistep_schedule(
        args.lr, steps_per_epoch, [int(m) for m in milestones.split(",")],
        1.0 / float(decay))
    model = DepthNetHybrid(ModelConfig(
        ndepths=args.ndepths, depth_min=args.depth_min,
        depth_max=args.depth_max, resnet=args.resnet,
        est_transformer=not args.no_est,
        frustum_mode=resolve_frustum_mode(args.exact_warp, args.exact_z),
        two_pass_warp=args.two_pass_warp,
        sequential_cost_bn=args.sequential_cost_bn), seed=args.seed)
    model.to(device)
    if args.pretrained_encoder:
        encoder = load_pretrained_encoder(args.pretrained_encoder)
        target = model.state_dict()
        if not any(k in target and v.shape == target[k].shape
                   for k, v in encoder.items()):
            raise ValueError(f"{args.pretrained_encoder}: no tensor fits "
                             f"the ResNet-{args.resnet} encoder")
        model.load_state_dict(partial_restore(target, encoder))
        print(f"pretrained encoder loaded from {args.pretrained_encoder}")
    frozen = tuple(name for flag, name in zip(
        (args.fix_matching_feature, args.fix_semantic_feature), ENCODERS)
        if flag)
    optimizer, scheduler = make_optimizer(
        model.named_parameters(), schedule, args.wd, frozen_prefixes=frozen)
    return TrainState(model, optimizer, scheduler), loader, steps_per_epoch


def dump_images(model, step: int, batch: dict, args) -> None:
    """Colourized depth and probability of an eval-mode forward of the
    batch's first window, and its ground truth, for the first target (the
    reference's save_images, train_hybrid.py:185-204)."""
    img_dir = os.path.join(args.logdir, "images")
    os.makedirs(img_dir, exist_ok=True)
    with torch.no_grad():
        outputs, _ = model(batch["imgs"][:1], batch["cam_poses"][:1],
                           batch["cam_intr"][:1], train=False)
    depth = outputs["depth"][0, 0, 0].cpu().numpy()
    prob = outputs["fused_prob"][0, 0].cpu().numpy()
    gt = batch["dmaps"][0, 0].cpu().numpy()
    for name, rgb in (
            ("depth", colorize_depth(depth, args.depth_min, args.depth_max)),
            ("prob", colorize_probmap(prob)),
            ("gt", colorize_depth(gt, args.depth_min, args.depth_max))):
        save_image(os.path.join(img_dir, f"{name}_{step:07d}.jpg"), rgb)


def run(args) -> dict:
    """The training loop; returns {"state", "records"}: the final
    TrainState and one record per logged step (step, epoch, seconds of the
    step, loader_seconds the loop waited for the batch, and the step's
    scalars as floats)."""
    device = resolve_device(args.device)
    set_fp32_numerics()
    if args.batch_per_device % args.grad_accum:
        raise SystemExit("--batch-per-device must be divisible by "
                         "--grad-accum")
    print("args:", vars(args))
    state, loader, steps_per_epoch = build(args, device)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"device={device} dataset={len(loader.dataset)} "
          f"steps/epoch={steps_per_epoch} params: {n_params / 1e6:.2f}M")

    ckpt = CheckpointManager(os.path.join(args.logdir, "ckpt"))
    start_epoch = 0
    if args.resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        start_epoch = state.step // steps_per_epoch
        print(f"resumed from step {state.step} (epoch {start_epoch})")
    elif args.loadckpt:
        loaded = load_weights_for_finetune(args.loadckpt)
        if args.restore_part:  # encoders only (train_hybrid.py:338-347)
            loaded = {k: v for k, v in loaded.items()
                      if k.split(".")[0] in ENCODERS}
        state.model.load_state_dict(
            partial_restore(state.model.state_dict(), loaded))
        print(f"loaded weights from {args.loadckpt} "
              f"(restore_part={args.restore_part})")

    step_fn = make_train_step(
        state.model, state.optimizer, state.scheduler, args.depth_min,
        args.depth_max, remat=args.remat, grad_accum=args.grad_accum,
        remat_policy=args.remat_policy)
    logger = ScalarLogger(args.logdir)
    meter = DictAverageMeter()
    records, total_steps = [], 0
    # anomaly mode as a context: on for the loop with --debug-nans
    with torch.autograd.set_detect_anomaly(args.debug_nans):
        for epoch in range(start_epoch, args.epochs):
            clip = 10.0 if epoch < 3 else 1.0  # train_hybrid.py:94-97
            # closing the epoch's iterator stops the loader's threads
            with contextlib.closing(loader.epoch(epoch)) as source:
                batches = prefetch_to_device(source, device)
                while True:
                    t0 = time.perf_counter()
                    batch = next(batches, None)
                    if batch is None:
                        break
                    t1 = time.perf_counter()
                    scalars = step_fn(batch, clip)
                    state.step += 1
                    total_steps += 1
                    if state.step % args.summary_freq == 0:
                        scalars = {k: float(v) for k, v in scalars.items()}
                        dt = time.perf_counter() - t1
                        meter.update(scalars)
                        logger.log(state.step, scalars)
                        records.append({"step": state.step, "epoch": epoch,
                                        "seconds": dt,
                                        "loader_seconds": t1 - t0,
                                        **scalars})
                        print(f"epoch {epoch} step {state.step} "
                              f"loss {scalars['loss']:.4f} "
                              f"delta0 {scalars['delta_0']:.4f} "
                              f"thred0 {scalars['thred_0']:.4f} "
                              f"time {dt:.3f}s wait {t1 - t0:.3f}s")
                    if state.step % args.image_freq == 0:
                        dump_images(state.model, state.step, batch, args)
                    if state.step % args.ckpt_steps == 0:
                        ckpt.save(state.step, state)
                    if args.steps and total_steps >= args.steps:
                        break
            ckpt.save(state.step, state)
            if args.steps and total_steps >= args.steps:
                break
    logger.close()
    if meter.count:
        print("mean of logged steps:", " ".join(
            f"{k}={v:.4f}" for k, v in meter.mean().items()))
    print("training done")
    return {"state": state, "records": records}


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
