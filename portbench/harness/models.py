"""The port's model and the plain reference of a configuration, with the
same weights from the seed, through the configuration's model family.

A configuration's file names its family under `family` (DEFAULT_FAMILY
where it names none): the file `portbench/families/<family>.py` of the
checkout the configuration was loaded from (harness/cell.py), found by
name as protocols and readers are. A family defines

- `structure(config)`: the reference's module tree; it is built here on
  the meta device, and the seed's state_dict is made from it
  (harness/weights.py);
- `reference(config, state, device)`: the plain float32 reference, kept
  under `portbench/reference/`;
- `port(config, state, device)`: the port's model on its normal path;

and raises ValueError on any setting its reference does not compute. A new
architecture is a new family and a new reference: no file here changes.
"""

from __future__ import annotations

from pathlib import Path

import torch

from portbench.harness.cell import family_file, load_module
from portbench.harness.weights import make_state_dict

PACKAGE = Path(__file__).resolve().parents[1]


def set_numerics(tf32: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def family(config: dict):
    """The family module of `config`: the file that `cell.load` recorded,
    or that of this package for a configuration made in code."""
    return load_module(Path(config.get("family_file")
                            or family_file(PACKAGE, config)))


def weights(config: dict, seed: int, device) -> dict:
    fam = family(config)
    with torch.device("meta"):
        structure = fam.structure(config)
    return make_state_dict(structure, seed, device)


def reference(config: dict, state: dict, device):
    return family(config).reference(config, state, device)


def port(config: dict, state: dict, device):
    return family(config).port(config, state, device)
