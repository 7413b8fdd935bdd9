"""Training entry point of the port (the flags of the repo's
``train_stereo.py``, reference train_stereo.py).

    python -m realtime_stereo_matcher_tpu_torch.train_stereo \\
        --exp_config_json=configure/stereo_net_v2_synthetic_config.json

trains the config's model on its ``train.datasets`` with its train section
(``train/trainer.py``): the kernel train path where it applies, bf16 when
the config's ``model.mixed_precision`` is set (the default) unless
``--no-bf16``, the scenes resident on the card and augmented there under
``train.device_augment``.  ``--max_steps`` caps the run (n + 1 steps, as
the reference loop takes).  It runs on the card unless ``--device cpu`` is
given, and raises when CUDA is asked for and absent.  Checkpoints and the
metric log go under the config's ``path``.

Data-parallel training: start one process per rank, each with
``RSM_COORDINATOR`` (host:port of rank 0's rendezvous),
``RSM_NUM_PROCESSES`` and ``RSM_PROCESS_ID``, as for the JAX package's
``train_stereo.py``::

    for r in 0 1; do RSM_COORDINATOR=localhost:29500 RSM_NUM_PROCESSES=2 \
        RSM_PROCESS_ID=$r python -m realtime_stereo_matcher_tpu_torch.train_stereo \
        --exp_config_json=... & done; wait

The process group is joined before any device use
(``parallel/distributed.py`` ``initialize``); rank r trains on
``cuda:{r % device_count}`` (over NCCL with a card a rank, over gloo where
ranks share a card) and the config's ``train.batch_size`` is the global
batch.  A failed rendezvous or a rank that dies fails the run.
"""

from __future__ import annotations

import argparse
import logging

import torch
import torch.distributed as dist

from realtime_stereo_matcher_tpu_torch.config import load_config
from realtime_stereo_matcher_tpu_torch.parallel.distributed import (
    default_group,
    initialize,
    rank_and_world,
    shutdown,
)
from realtime_stereo_matcher_tpu_torch.train.trainer import train
from realtime_stereo_matcher_tpu_torch.utils.logger import setup_basic_logging


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--exp_config_json",
                        default="configure/stereo_net_config_v4.json",
                        help="experiment configure json file")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="optional cap on training steps")
    parser.add_argument("--bf16", dest="bf16", action="store_true",
                        default=None, help="force bf16 compute")
    parser.add_argument("--no-bf16", dest="bf16", action="store_false")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda; raises "
                             "when CUDA is absent)")
    return parser.parse_args(argv)


def main(argv=None, **train_kwargs) -> str:
    """Train per the config; returns the final checkpoint's path.
    ``train_kwargs`` go to ``train()`` (its ``on_step`` / ``on_batch``
    hooks)."""
    args = parse_args(argv)
    setup_basic_logging()
    device = torch.device(args.device)
    joined_before = dist.is_initialized()
    distributed = initialize(device=device)  # before any device use
    try:
        if distributed and device.type == "cuda" and device.index is None:
            rank, _ = rank_and_world(default_group())
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        exp_config = load_config(args.exp_config_json)
        final_ckpt = train(exp_config, max_steps=args.max_steps,
                           use_bf16=args.bf16, device=device, **train_kwargs)
        logging.info("Final checkpoint: %s", final_ckpt)
        return final_ckpt
    finally:
        if distributed and not joined_before:
            shutdown()


if __name__ == "__main__":
    main()
