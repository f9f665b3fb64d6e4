"""Command-line arguments and the config they build.

Copy of ``asf_tpu/utils/parser.py``: ``--shard_id``, ``--num_shards``,
``--init_method``, ``--cfg`` and trailing ``KEY VALUE`` overrides, merged as
defaults, then the config file (YAML through ``config/yaml_lite.py``, or
JSON), then the overrides (``merge_from_list``). The port adds
``--device``: the current CUDA device (each rank its own card, over NCCL)
unless it says ``cpu`` (ranks over gloo).
"""

import argparse
import sys

from ..config import get_cfg


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Provide AudioSlowFast (PyTorch/CUDA) training and testing pipeline."
    )
    parser.add_argument(
        "--shard_id",
        help="The shard id of current node, starts from 0 to num_shards - 1",
        default=0,
        type=int,
    )
    parser.add_argument(
        "--num_shards",
        help="Number of shards using by the job",
        default=1,
        type=int,
    )
    parser.add_argument(
        "--init_method",
        help="Initialization method, includes TCP or shared file-system",
        default="tcp://localhost:9999",
        type=str,
    )
    parser.add_argument(
        "--cfg",
        dest="cfg_file",
        help="Path to the config file",
        default=None,
        type=str,
    )
    parser.add_argument(
        "--device",
        help="Device to run on: the current CUDA device unless 'cpu'",
        default=None,
        type=str,
    )
    parser.add_argument(
        "opts",
        help="See asf_tpu_torch/config/defaults.py for all options",
        default=None,
        nargs=argparse.REMAINDER,
    )
    if argv is None and len(sys.argv) == 1:
        parser.print_help()
    return parser.parse_args(argv)


def load_config(args):
    """Build a config: defaults -> config file -> CLI opts."""
    cfg = get_cfg()
    if getattr(args, "cfg_file", None) is not None:
        cfg.merge_from_file(args.cfg_file)
    if getattr(args, "opts", None):
        cfg.merge_from_list(args.opts)

    if hasattr(args, "num_shards") and hasattr(args, "shard_id"):
        cfg.NUM_SHARDS = args.num_shards
        cfg.SHARD_ID = args.shard_id

    return cfg
