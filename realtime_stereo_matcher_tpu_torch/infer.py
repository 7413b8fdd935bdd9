"""Batch-inference entry point of the port (the flags of the repo's
``test_stereo.py``, reference test_stereo.py).

Globs left images, pairs them with right images by filename substring
replacement, runs the configured model, and writes a PFM disparity map and
a jet-colour PNG for each pair:

    python -m realtime_stereo_matcher_tpu_torch.infer --exp_config_json=... \\
        --model_chkpt_file=... --left='/data/*_left.png' \\
        --replace _left _right --output out/

It runs on the card unless ``--device cpu`` is given (as ``evaluate``:
the bf16 kernel path on the card for a mixed-precision config, or for V4
and DispNetC their plain forward in bf16; the plain float32 model on the
CPU) and prints each pair's FPS, timed on the host
around the forward and a synchronisation.  It reads the images and writes
the PNG through Pillow, so it runs only where Pillow is installed: without
it, ``main`` raises ``ImportError`` before it builds the model.
(``evaluate`` on the synthetic scenes needs no Pillow.)
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from realtime_stereo_matcher_tpu_torch.config import load_config
from realtime_stereo_matcher_tpu_torch.evaluate import FAST, build_runner
from realtime_stereo_matcher_tpu_torch.ops import InputPadder
from realtime_stereo_matcher_tpu_torch.utils.colorize import colorize_2d_matrix
from realtime_stereo_matcher_tpu_torch.utils.logger import setup_basic_logging
from realtime_stereo_matcher_tpu_torch.utils.pfm import write_pfm


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--exp_config_json",
                        default="configure/opencv_sgbm_config.json")
    parser.add_argument("--model_chkpt_file", default="")
    parser.add_argument("--left", required=True, help="left image glob")
    parser.add_argument("--replace", nargs=2, default=["_left_Img", "_right_Img"],
                        help="left->right filename substring replacement")
    parser.add_argument("--output", required=True, help="output path")
    parser.add_argument("--fast", choices=sorted(FAST), default="auto",
                        help="kernel inference path (default: auto = on "
                             "when running on CUDA)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda; raises "
                             "when CUDA is absent)")
    return parser.parse_args(argv)


def main(argv=None) -> list[str]:
    """Returns the paths of the PFM files written."""
    args = parse_args(argv)
    setup_basic_logging()
    from PIL import Image

    exp_config = load_config(args.exp_config_json)
    # like test_stereo.py, a trainable config without a checkpoint runs
    # its initial weights
    runner = build_runner(exp_config, args.model_chkpt_file,
                          fast=FAST[args.fast], device=args.device,
                          allow_random_weights=True)

    save_path = os.path.join(args.output, exp_config.name)
    os.makedirs(save_path, exist_ok=True)

    l_suffix, r_suffix = args.replace
    divis_by = 2 ** exp_config.model.downsample_factor
    written = []
    for l_img_file in sorted(glob.glob(args.left)):
        r_img_file = l_img_file.replace(l_suffix, r_suffix)
        if not os.path.exists(r_img_file) or r_img_file == l_img_file:
            continue
        l_img_name = os.path.splitext(os.path.basename(l_img_file))[0].replace(
            l_suffix, "")

        l_img = np.array(Image.open(l_img_file))[..., :3].astype(np.float32)
        r_img = np.array(Image.open(r_img_file))[..., :3].astype(np.float32)
        h, w = l_img.shape[:2]

        padder = InputPadder((1, h, w, 3), divis_by=divis_by)
        li, ri = padder.pad(*(torch.from_numpy(a[None]).to(runner.device)
                              for a in (l_img, r_img)))

        start = time.time()
        flow_pr = runner(li, ri)[-1]
        if flow_pr.is_cuda:
            torch.cuda.synchronize(flow_pr.device)
        end = time.time()
        print(f"The model inference on {l_img_file} FPS: "
              f"{1.0 / max(end - start, 1e-9):.4f}.")

        flow_pr = padder.unpad(flow_pr.float()).cpu().numpy()
        disp = -1.0 * flow_pr[0, :, :, 0].astype(np.float32)
        color = colorize_2d_matrix(disp, min_val=1.0, max_val=64.0)

        pfm_file = os.path.join(save_path, f"{l_img_name}_{w}x{h}_disparity.pfm")
        write_pfm(pfm_file, disp, 1.0)
        png_file = os.path.join(save_path, f"{l_img_name}_{w}x{h}_disparity.png")
        Image.fromarray(color[:, :, ::-1]).save(png_file)  # color is BGR
        written.append(pfm_file)
    return written


if __name__ == "__main__":
    main()
