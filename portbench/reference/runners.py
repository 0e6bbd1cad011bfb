"""The eval protocols and the training step around the reference model,
plain PyTorch: what the port's `eval/estm.py:ESTMRunner`,
`tools/eval_joint.py:JointRunner` and `train/trainer.py:make_train_step`
do, written again from the reference recipe (eval_hybrid_seq.py,
eval_hybrid.py, train_hybrid.py) for the benchmark's comparison. Nothing
of the port is imported.
"""

from __future__ import annotations

import torch

from portbench.reference.model import (
    DepthNetHybrid, Memory, clip_grad_norm, multi_scale_loss,
)


def _dev(x, device, dtype=None):
    return torch.as_tensor(x).to(device=device, dtype=dtype)


@torch.no_grad()
def stream_maps(model: DepthNetHybrid, frames, poses, intr, scales,
                lwindow: int = 3, memory_size: int = 2):
    """ESTM streaming over frames [n, H, W, 3] (uint8) with poses
    [n, 4, 4] and intr [3, 3]: one [len(scales), H, W] map of the window's
    centre frame per frame from the lwindow-th on; the first window runs
    without EST fusion, later ones fuse a FIFO memory of `memory_size`
    key/value volumes; the matching features of the frames a window shares
    with the previous one are carried over."""
    dev = next(model.parameters()).device
    n, h, w, _ = frames.shape
    k = _dev(intr, dev, torch.float32)[None]
    memory = Memory.create(1, memory_size, model.ndepths, h // 4, w // 4, 16,
                           dev)
    feats = None
    out = []
    for i in range(lwindow - 1, n):
        lo = i - lwindow + 1
        imgs = _dev(frames[lo:i + 1], dev)[None]
        p = _dev(poses[lo:i + 1], dev, torch.float32)[None]
        if feats is None:
            feats = model.matching(imgs[0])[None]
        else:
            new = model.matching(imgs[0, -1:])[None]
            feats = torch.cat([feats[:, 1:], new], 1)
        use_est = i > lwindow - 1
        outputs, (key, value, pose) = model(
            imgs, p, k, memory=memory if use_est else None, use_est=use_est,
            feats=feats)
        memory = memory.push(key, value, pose)
        out.append(outputs["depth"][0, 0, list(scales)])
    return out


@torch.no_grad()
def joint_maps(model: DepthNetHybrid, windows, intr, scales):
    """Joint windows in order, each (frames [V, H, W, 3], poses
    [V, 4, 4]), the last target's key/value threaded to the next window as
    a 1-entry memory (eval_hybrid.py:229-243): [V-2, len(scales), H, W]
    per window."""
    dev = next(model.parameters()).device
    k = _dev(intr, dev, torch.float32)[None]
    memory, out = None, []
    for frames, poses in windows:
        outputs, (key, value, pose) = model(
            _dev(frames, dev)[None], _dev(poses, dev, torch.float32)[None], k,
            memory=memory, use_est=memory is not None)
        memory = Memory.single(key, value, pose)
        out.append(outputs["depth"][0][:, list(scales)])
    return out


def lr_of_update(n: int, base_lr: float, warmup_steps: int = 500,
                 warmup_factor: float = 1.0 / 3.0) -> float:
    """The learning rate of update n = 1, 2, ... in the warm-up
    (WarmupMultiStepLR, utils/utils.py:208-252; no decay milestone falls
    in the first epoch)."""
    warm = min((n - 1) / warmup_steps, 1.0)
    return base_lr * (warmup_factor * (1.0 - warm) + warm)


def train_steps(model: DepthNetHybrid, batches, lr: float,
                weight_decay: float, clip: float, loss_weight: float = 0.8):
    """Adam-with-L2 steps (train_hybrid.py:155-211,308) on `batches`
    (dicts of imgs [B, V, H, W, 3], cam_poses, cam_intr, dmaps and dmasks
    [B, T, H, W], on the model's device), the model in train mode with
    EST fusion. Returns (losses, first gradients as Adam got them: the
    clipped gradient plus the L2 term, per parameter name)."""
    model.train()
    params = dict(model.named_parameters())
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=weight_decay,
                           foreach=False)
    losses, first = [], None
    for n, b in enumerate(batches, 1):
        for g in opt.param_groups:
            g["lr"] = lr_of_update(n, lr)
        opt.zero_grad(set_to_none=True)
        outputs, _ = model(b["imgs"], b["cam_poses"], b["cam_intr"],
                           use_est=True)
        loss = multi_scale_loss(outputs["depth"], b["dmaps"], b["dmasks"],
                                loss_weight)
        loss.backward()
        clip_grad_norm(params.values(), clip)
        if first is None:
            first = {k: (p.grad + weight_decay * p.detach()).clone()
                     for k, p in params.items() if p.grad is not None}
        opt.step()
        losses.append(float(loss.detach()))
    model.eval()
    return losses, first
