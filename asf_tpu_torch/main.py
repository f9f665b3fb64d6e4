"""Prepare an EPIC-KITCHENS set, train, then test, from one config file.

    python -m asf_tpu_torch.main --config cfg.yaml --train [--device cpu]
    python -m asf_tpu_torch.main --config cfg.yaml --test [--device cpu]

Counterpart of the repo's root ``main.py``: the YAML (``config/yaml_lite.py``)
or JSON file merged onto the defaults; with ``--train``, the dataset
preparation (``state/dataset_prep.py``) unless
``EPICKITCHENS.SKIP_PREPARATION``, in which case each processed train and
val list under ``EPICKITCHENS.ANNOTATIONS_DIR`` must exist (else exit 1),
then ``train(cfg)`` and ``test(cfg)`` with a config read afresh from the
file, each through ``tools/run_net.py:launch_job`` (``NUM_GPUS`` ranks on
this host); with ``--test`` alone, ``test(cfg)``. Runs on the current CUDA
device unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

from .config import get_cfg
from .engine import test, train
from .state.dataset_prep import prepare_dataset
from .tools.run_net import launch_job
from .utils.logging import get_logger, setup_logging

logger = get_logger(__name__)


def parse_args(argv=None) -> dict:
    p = argparse.ArgumentParser(description="AudioSlowFast (PyTorch/CUDA)")
    p.add_argument("--config", type=str, required=True, help="Path to the config YAML")
    p.add_argument("--train", action="store_true", help="Run training (then testing)")
    p.add_argument("--test", action="store_true", help="Run testing only")
    p.add_argument("--device", type=str, default=None,
                   help="Device to run on: the current CUDA device unless 'cpu'")
    return vars(p.parse_args(argv))


def _load(path: str):
    cfg = get_cfg()
    cfg.merge_from_file(path)
    return cfg


def main(args: dict) -> None:
    cfg = _load(args["config"])
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    setup_logging(cfg.OUTPUT_DIR)
    device = args.get("device")

    if args["train"]:
        if not cfg.EPICKITCHENS.SKIP_PREPARATION:
            prepare_dataset(cfg)
        else:
            # the paths the datasets read (ANNOTATIONS_DIR joined with each name)
            for name in (cfg.EPICKITCHENS.PROCESSED_TRAIN_LIST,
                         cfg.EPICKITCHENS.PROCESSED_VAL_LIST):
                path = os.path.join(cfg.EPICKITCHENS.ANNOTATIONS_DIR, name)
                if not os.path.exists(path):
                    logger.error("Processed list %s does not exist", path)
                    raise SystemExit(1)
        launch_job(cfg, None, train, device)
        launch_job(_load(args["config"]), None, test, device)
    elif args["test"]:
        launch_job(cfg, None, test, device)
    else:
        logger.error("Nothing to do: pass --train or --test")


if __name__ == "__main__":
    main(parse_args())
