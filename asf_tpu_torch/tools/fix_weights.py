"""Add or strip a prefix of every ``model_state`` key of a ``.pyth`` checkpoint.

    python -m asf_tpu_torch.tools.fix_weights in.pyth out.pyth --add-prefix model.
    python -m asf_tpu_torch.tools.fix_weights in.pyth out.pyth --strip-prefix module.

Copy of ``asf_tpu/tools/fix_weights.py``; the rest of the checkpoint is
written as it was. The port's loader takes prefixes off itself
(``TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN``): this is for other consumers.
"""

from __future__ import annotations

import argparse
from collections import OrderedDict

import torch

from ..utils.logging import get_logger

logger = get_logger(__name__)


def fix_state_keys(model_state, add_prefix: str = "", strip_prefix: str = ""):
    out = OrderedDict()
    for k, v in model_state.items():
        nk = k
        if strip_prefix and nk.startswith(strip_prefix):
            nk = nk[len(strip_prefix):]
        if add_prefix:
            nk = add_prefix + nk
        out[nk] = v
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("input", help="Source .pyth checkpoint")
    parser.add_argument("output", help="Destination .pyth checkpoint")
    parser.add_argument("--add-prefix", default="", help='e.g. "model."')
    parser.add_argument("--strip-prefix", default="", help='e.g. "module."')
    args = parser.parse_args(argv)

    ckpt = torch.load(args.input, map_location="cpu", weights_only=False)
    ckpt["model_state"] = fix_state_keys(ckpt["model_state"], args.add_prefix, args.strip_prefix)
    with open(args.output, "wb") as f:
        torch.save(ckpt, f)
    logger.info("Wrote %s (%d keys)", args.output, len(ckpt["model_state"]))


if __name__ == "__main__":
    main()
