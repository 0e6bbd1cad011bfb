"""Export the ESTM (or Joint) window step as a serving artifact
(counterpart of tools/export_serving.py; estdepth_tpu_torch/serving.py).

    python -m estdepth_tpu_torch.tools.export_serving --out DIR
        [--ckpt PATH] [--joint] [--verify N] [--device cpu]

Writes DIR/manifest.json, first.pt2 and steady.pt2: the two programs of
the window step with the weights stored in each, exported on --device
(default the CUDA device). Load them with serving.load_stream (or
load_joint with --joint), on the card or the CPU, wherever they were
exported. Weights: random from --seed, or --ckpt, a reference checkpoint
(.ckpt/.pth/.pt/.tar) or a checkpoint directory of tools/train.py. The
warp and dtype flags are the eval tools' (--exact-warp, --no-exact-z,
--fused-attention, --bf16: a bfloat16 model, whose manifest says
"memory_dtype": "bfloat16"). --verify N streams N synthetic frames (N
windows with --joint) through the reloaded artifact and through the live
ESTMRunner (JointRunner) and prints the max |depth delta|; above 1e-3 it
writes DIR/VERIFY_FAILED, which the loaders refuse, and exits non-zero.

Not here, of the JAX tool's flags: --conv3d-as2d, --pallas-warp and
--fast-frustum are TPU re-expressions, and the port picks its warps with
the flags above; --precision does not apply, the port's float32 runs
with TF32 off; --platforms becomes --device, and the loader moves an
artifact to the device it loads on.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from estdepth_tpu_torch import serving
from estdepth_tpu_torch.config import (
    EvalConfig, ModelConfig, add_model_flags, resolve_device,
    set_fp32_numerics,
)
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, synthetic_stream,
)
from estdepth_tpu_torch.eval.estm import ESTMRunner
from estdepth_tpu_torch.tools.eval_estm import build_model
from estdepth_tpu_torch.tools.eval_joint import JointRunner

VERIFY_TOL = 1e-3  # max |depth delta| of a verified artifact


def parse_args(argv=None):
    ev, mc = EvalConfig(), ModelConfig()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out", type=str, required=True,
                   help="artifact output directory")
    p.add_argument("--ckpt", type=str, default=None,
                   help="a reference checkpoint (.ckpt/.pth/.pt/.tar) or a "
                        "checkpoint directory of tools/train.py; default "
                        "random weights from --seed")
    p.add_argument("--height", type=int, default=ev.height)
    p.add_argument("--width", type=int, default=ev.width)
    p.add_argument("--ndepths", type=int, default=mc.ndepths)
    p.add_argument("--depth-min", type=float, default=mc.depth_min)
    p.add_argument("--depth-max", type=float, default=mc.depth_max)
    p.add_argument("--resnet", type=int, default=mc.resnet)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights without --ckpt")
    add_model_flags(p)
    p.add_argument("--batch", type=int, default=1,
                   help="independent streams per exported step")
    p.add_argument("--lwindow", type=int, default=ev.lwindow)
    p.add_argument("--memory-size", type=int, default=ev.memory_size)
    p.add_argument("--joint", action="store_true",
                   help="export the Joint protocol instead (seq_length-"
                        "frame windows advancing by seq_length-2, "
                        "seq_length-2 target depths per window, a 1-entry "
                        "memory); load with serving.load_joint")
    p.add_argument("--seq-length", type=int, default=5,
                   help="window length with --joint")
    p.add_argument("--scales", type=str, default="0",
                   help="comma-separated output depth scales (default: the "
                        "refined scale-0 map only)")
    p.add_argument("--output-bf16", action="store_true",
                   help="cast the returned depth maps to bfloat16 "
                        "(whatever the model's dtype, --bf16)")
    p.add_argument("--verify", type=int, default=0, metavar="N",
                   help="replay N synthetic frames (N windows with "
                        "--joint) through the reloaded artifact and the "
                        "live runner and compare them")
    p.add_argument("--device", type=str, default=None,
                   help="device to export on and verify on (default: the "
                        "CUDA device)")
    return p.parse_args(argv)


def _scales(args) -> tuple:
    return tuple(int(s) for s in args.scales.split(","))


def _output_dtype(args):
    return torch.bfloat16 if args.output_bf16 else None


def _max_delta(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def verify(args, model, n: int) -> float:
    """The same synthetic scene through the reloaded artifact and the live
    runner on --device; the max |depth delta| over the emitted maps."""
    dev = resolve_device(args.device)
    scales, out_dtype = _scales(args), _output_dtype(args)
    cfg = SyntheticSceneConfig(height=args.height, width=args.width,
                               focal=args.width * 0.6)
    stride = args.seq_length - 2
    n_frames = max(n, 1) * stride + 2 if args.joint else n
    frames = list(synthetic_stream(cfg, n_frames, args.depth_min,
                                   args.depth_max))
    max_delta = 0.0
    if args.joint:
        live = JointRunner(model, est_on=True, device=dev)
        exported = serving.load_joint(args.out, device=dev)
        for fi, f in enumerate(frames):
            got = exported.push_frame(f["img"], f["cam_pose"], f["cam_intr"])
            if got is None:
                continue
            window = frames[fi + 1 - args.seq_length:fi + 1]
            imgs, poses = (np.repeat(np.stack([w[k] for w in window])[None],
                                     args.batch, 0)
                           for k in ("img", "cam_pose"))
            intr = np.repeat(f["cam_intr"][None], args.batch, 0)
            want = live.run_window(imgs, poses, intr)[0][:, :, list(scales)]
            max_delta = max(max_delta, _max_delta(want.to(got.dtype), got))
        return max_delta
    live = ESTMRunner(model, args.height, args.width, lwindow=args.lwindow,
                      memory_size=args.memory_size, batch=args.batch,
                      output_scales=scales, output_dtype=out_dtype,
                      device=dev)
    exported = serving.load_stream(args.out, device=dev)
    for f in frames:
        want = live.push_frame(f["img"], f["cam_pose"], f["cam_intr"])
        got = exported.push_frame(f["img"], f["cam_pose"], f["cam_intr"])
        if (want is None) != (got is None):
            raise AssertionError("the artifact and the live runner emit "
                                 "on different frames")
        if want is not None:
            max_delta = max(max_delta, _max_delta(want, got))
    return max_delta


def verify_or_quarantine(args, model) -> float:
    """`verify` the artifact in --out; above VERIFY_TOL write
    --out/VERIFY_FAILED, which the loaders refuse, and exit non-zero.
    Returns the max |depth delta|."""
    delta = verify(args, model, args.verify)
    unit = "windows" if args.joint else "frames"
    print(f"verify: max |depth delta| over {args.verify} {unit} = "
          f"{delta:.3e}")
    if not delta <= VERIFY_TOL:
        marker = os.path.join(args.out, "VERIFY_FAILED")
        with open(marker, "w") as f:
            f.write(f"max |depth delta| {delta:.6e} > {VERIFY_TOL}\n")
        sys.exit(f"verification FAILED (delta {delta:.3e} > {VERIFY_TOL}); "
                 f"wrote {marker}")
    return delta


def export(args, model) -> serving.StreamArtifact:
    kw = dict(height=args.height, width=args.width, batch=args.batch,
              output_scales=_scales(args), output_dtype=_output_dtype(args),
              device=args.device)
    if args.joint:
        return serving.export_joint(model, seq_length=args.seq_length, **kw)
    return serving.export_stream(model, lwindow=args.lwindow,
                                 memory_size=args.memory_size, **kw)


def main(argv=None) -> dict:
    """The tool; returns {"export_s", "bytes", "max_abs_delta" (None
    without --verify)}."""
    args = parse_args(argv)
    resolve_device(args.device)
    set_fp32_numerics()
    model = build_model(args)
    t0 = time.perf_counter()
    artifact = export(args, model)
    nbytes = artifact.save(args.out)
    export_s = time.perf_counter() - t0
    print(f"exported {args.out} ({nbytes / 1e6:.1f} MB, "
          f"protocol={artifact.manifest['protocol']}, "
          f"device={artifact.manifest['device']}, {export_s:.1f}s)")
    result = {"export_s": export_s, "bytes": nbytes, "max_abs_delta": None}
    if args.verify:
        result["max_abs_delta"] = verify_or_quarantine(args, model)
    return result


if __name__ == "__main__":
    main()
