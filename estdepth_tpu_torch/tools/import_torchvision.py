"""Convert ImageNet-pretrained torchvision ResNet weights into the context
encoder's initialization (counterpart of tools/import_torchvision.py).

    python -m estdepth_tpu_torch.tools.import_torchvision \\
        --pth resnet50-0676ba61.pth --out resnet50_enc.npz

The reference trains its context encoder from torchvision's pretrained
weights (hybrid_models/resnet_encoder.py:35, `pretrained=True`). This tool
reads a local torchvision resnet{18,34,50,101,152} state_dict (`.pth`,
read with `weights_only=True`; nothing is downloaded) and writes the same
`.npz` as the JAX package's tool, name for name: the arrays of the JAX
`semantic_feature` subtree under their `params/...` and `batch_stats/...`
paths. Either package's `train --pretrained-encoder` takes the `.npz`, and
the port's also takes the `.pth` itself.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from estdepth_tpu_torch.utils.convert import convert_torchvision_resnet


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--pth", required=True,
                   help="torchvision resnet state_dict (.pth)")
    p.add_argument("--out", required=True, help="output .npz path")
    args = p.parse_args(argv)

    blob = torch.load(args.pth, map_location="cpu", weights_only=True)
    flat = convert_torchvision_resnet(blob)
    np.savez(args.out, **flat)
    n_values = sum(v.size for v in flat.values())
    print(f"wrote {args.out}: {len(flat)} tensors, "
          f"{n_values / 1e6:.2f}M values")
    return flat


if __name__ == "__main__":
    main()
