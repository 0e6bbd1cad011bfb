"""Train DepthNetHybrid on one device (counterpart of tools/train.py).

    python -m estdepth_tpu_torch.tools.train --synthetic --steps 4

The reference's recipe (train_hybrid.py): Adam 4e-5 with L2 4e-4, linear
warm-up then multi-step decay, gradient clip 10 for epochs < 3 and 1 after,
5-frame windows (3 targets), batch 1, float32. The defaults are the JAX
tool's sizes (256x320, 64 planes in [0.01, 10] m, ResNet-50). The forward
runs the CUDA warp kernels (the plane sweep, and the exact-z frustum warp
of the EST fusion; --two-pass-warp sweeps through the fused two-pass
resample instead); their gradients are the plain versions'. Data: synthetic
scenes with analytic depth (--synthetic, the only source ported so far).
Writes scalars to <logdir>/scalars.jsonl and checkpoints to <logdir>/ckpt;
--resume continues from the latest one. Runs on the CUDA device unless
--device cpu is given.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from estdepth_tpu_torch.config import (
    ModelConfig, TrainConfig, resolve_device, resolve_frustum_mode,
    set_fp32_numerics,
)
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
from estdepth_tpu_torch.utils.logging import DictAverageMeter, ScalarLogger

ENCODERS = ("matchingFeature", "semanticFeature")


def parse_args(argv=None):
    mc, tc = ModelConfig(), TrainConfig()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--synthetic", action="store_true", required=True,
                   help="train on generated synthetic scenes (the only data "
                        "source ported so far)")
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
    p.add_argument("--seed", type=int, default=tc.seed)
    p.add_argument("--summary-freq", type=int, default=tc.summary_freq)
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


def epoch_batches(dataset, batch_size: int, epoch: int, seed: int):
    """The epoch's batches as dicts of stacked numpy arrays: one seeded
    permutation per epoch, the ragged tail dropped."""
    order = np.random.default_rng([seed, epoch]).permutation(len(dataset))
    for i in range(len(dataset) // batch_size):
        items = [dataset[j] for j in order[i * batch_size:
                                           (i + 1) * batch_size]]
        yield {k: np.stack([it[k] for it in items]) for k in items[0]}


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def build(args, device):
    """The model, optimizer, scheduler and dataset `args` describe:
    (state, dataset, steps_per_epoch)."""
    dataset = SyntheticTrainDataset(256, args.height, args.width,
                                    args.n_frames, args.depth_min,
                                    args.depth_max)
    steps_per_epoch = max(len(dataset) // args.batch_per_device, 1)
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
    frozen = tuple(name for flag, name in zip(
        (args.fix_matching_feature, args.fix_semantic_feature), ENCODERS)
        if flag)
    optimizer, scheduler = make_optimizer(
        model.named_parameters(), schedule, args.wd, frozen_prefixes=frozen)
    return TrainState(model, optimizer, scheduler), dataset, steps_per_epoch


def run(args) -> dict:
    """The training loop; returns {"state", "records"}: the final
    TrainState and one record per logged step (step, epoch, seconds and
    the step's scalars as floats)."""
    device = resolve_device(args.device)
    set_fp32_numerics()
    if args.batch_per_device % args.grad_accum:
        raise SystemExit("--batch-per-device must be divisible by "
                         "--grad-accum")
    print("args:", vars(args))
    state, dataset, steps_per_epoch = build(args, device)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"device={device} dataset={len(dataset)} "
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
    for epoch in range(start_epoch, args.epochs):
        clip = 10.0 if epoch < 3 else 1.0  # train_hybrid.py:94-97
        for batch in epoch_batches(dataset, args.batch_per_device, epoch,
                                   args.seed):
            batch = to_device(batch, device)
            t0 = time.perf_counter()
            scalars = step_fn(batch, clip)
            state.step += 1
            total_steps += 1
            if state.step % args.summary_freq == 0:
                scalars = {k: float(v) for k, v in scalars.items()}
                dt = time.perf_counter() - t0
                meter.update(scalars)
                logger.log(state.step, scalars)
                records.append({"step": state.step, "epoch": epoch,
                                "seconds": dt, **scalars})
                print(f"epoch {epoch} step {state.step} "
                      f"loss {scalars['loss']:.4f} "
                      f"delta0 {scalars['delta_0']:.4f} "
                      f"thred0 {scalars['thred_0']:.4f} time {dt:.3f}s")
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
