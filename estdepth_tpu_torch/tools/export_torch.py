"""Write a tools/train.py checkpoint as a reference checkpoint (counterpart
of tools/export_torch.py).

    python -m estdepth_tpu_torch.tools.export_torch --ckpt LOGDIR/ckpt
        --out model_000060.ckpt [--step N]

Reads step N (default the latest) of a checkpoint directory written by
tools/train.py (utils/checkpoint.CheckpointManager) and saves
`torch.save({"epoch": N, "model": state_dict})`, the layout of the
reference's train_hybrid.py:137-151 without its optimizer. The port's
module names are the reference's, so the state_dict is written as it is;
utils/convert.load_reference_checkpoint (and the JAX package's
load_torch_checkpoint) read it back.
"""

from __future__ import annotations

import argparse

import torch

from estdepth_tpu_torch.utils.checkpoint import CheckpointManager


def export(ckpt_dir: str, out: str, step: int | None = None) -> dict:
    """Write step `step` (None: the latest) of `ckpt_dir` to `out`;
    returns {"step", "tensors"}."""
    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    blob = torch.load(mgr.path(step), map_location="cpu", weights_only=True)
    torch.save({"epoch": int(blob["step"]), "model": blob["model"]}, out)
    return {"step": int(blob["step"]), "tensors": len(blob["model"])}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ckpt", required=True,
                   help="checkpoint directory written by tools/train.py "
                        "(<logdir>/ckpt)")
    p.add_argument("--out", required=True, help="output .ckpt path")
    p.add_argument("--step", type=int, default=None,
                   help="the step to export (default: the latest)")
    args = p.parse_args(argv)
    res = export(args.ckpt, args.out, args.step)
    print(f"wrote {args.out}: {res['tensors']} tensors from step "
          f"{res['step']}")
    return res


if __name__ == "__main__":
    main()
