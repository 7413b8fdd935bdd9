"""Evaluation entry point of the port (the flags of the repo's
``evaluate_stereo.py``, reference evaluate_stereo.py).

    python -m realtime_stereo_matcher_tpu_torch.evaluate \\
        --exp_config_json=configure/stereo_net_v2_synthetic_56k_resume_config.json \\
        --model_chkpt_file=realtime_stereo_matcher_tpu_torch/weights/synth_stereo_net_v2-44000.pt

Runs the validators listed in the config's ``test.datasets`` with the
reference's metric math (EPE / D1 / bad-px / FPS) and prints their lines.
It runs on the card unless ``--device cpu`` is given, and raises when CUDA
is asked for and absent.  On the card ``--fast auto`` runs the kernel path
(``models/fast_infer.py``) in bf16 when the config's
``model.mixed_precision`` is set (the default), else in float32; on the
CPU it runs the plain float32 model.  MobileStereoNetV4 and MobileDispNetC
have no kernel path: on the card they run their plain forward, autocast to
bf16 under the same flag (``--fast on`` raises for them).  Weights load with
``models/checkpoint.py`` (the port's own files or a reference ``.pth``).
The classical SGBM config raises ``NotImplementedError``: that model is
not ported yet.
"""

from __future__ import annotations

import argparse
import logging

import torch

from realtime_stereo_matcher_tpu_torch.config import load_config
from realtime_stereo_matcher_tpu_torch.eval.validators import (
    ModelRunner,
    run_validation,
)
from realtime_stereo_matcher_tpu_torch.models import build_model, is_neural
from realtime_stereo_matcher_tpu_torch.models.checkpoint import load_weights
from realtime_stereo_matcher_tpu_torch.train.trainer import count_parameters
from realtime_stereo_matcher_tpu_torch.utils.logger import setup_basic_logging

FAST = {"auto": "auto", "on": True, "off": False}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--exp_config_json",
                        default="configure/opencv_sgbm_config.json",
                        help="experiment configure json file")
    parser.add_argument("--model_chkpt_file", default="",
                        help="model checkpoint file")
    parser.add_argument("--data_root", default=None,
                        help="dataset root override (else RSM_DATA_ROOT)")
    parser.add_argument("--fast", choices=sorted(FAST), default="auto",
                        help="kernel inference path (default: auto = on "
                             "when running on CUDA)")
    parser.add_argument("--allow_random_weights", action="store_true",
                        help="evaluate a trainable model without a checkpoint "
                             "(random init) -- off by default to match the "
                             "reference, which fails loudly in that case")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda; raises "
                             "when CUDA is absent)")
    return parser.parse_args(argv)


def build_runner(exp_config, model_chkpt_file: str, *, fast="auto",
                 device="cuda", allow_random_weights: bool = False
                 ) -> ModelRunner:
    """The config's model with its weights, in a ``ModelRunner`` on
    ``device``."""
    model_config = exp_config.model.as_dict()
    if not is_neural(model_config):
        build_model(model_config, device=device)  # raises: not ported yet
    if (exp_config.has_train and not model_chkpt_file
            and not allow_random_weights):
        # the reference fails loudly here too (torch.load on the empty
        # path, evaluate_stereo.py:307-311); a silent random-weight eval
        # reports garbage metrics
        raise SystemExit(
            "--model_chkpt_file is required for a trainable config "
            "(pass --allow_random_weights to evaluate random init).")
    model = build_model(model_config, device=device)
    if exp_config.has_train and model_chkpt_file:
        logging.info("Loading checkpoint: %s...", model_chkpt_file)
        load_weights(model_chkpt_file, model)
        logging.info("Done loading checkpoint.")
        print(f"The model has {count_parameters(model) / 1e6:.4f}M "
              f"learnable parameters.")
    dtype = (torch.bfloat16 if exp_config.model.mixed_precision
             else torch.float32)
    return ModelRunner(model, fast=fast, dtype=dtype, device=device)


def main(argv=None) -> dict:
    args = parse_args(argv)
    setup_basic_logging()
    exp_config = load_config(args.exp_config_json)
    runner = build_runner(exp_config, args.model_chkpt_file,
                          fast=FAST[args.fast], device=args.device,
                          allow_random_weights=args.allow_random_weights)
    results = run_validation(runner, exp_config.test.datasets,
                             data_root=args.data_root)
    for k, v in results.items():
        logging.info("%s: %.4f", k, v)
    return results


if __name__ == "__main__":
    main()
