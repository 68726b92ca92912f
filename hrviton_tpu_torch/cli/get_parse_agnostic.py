"""Offline parse-agnostic preprocessing CLI: the port's counterpart of
``hrviton_tpu/cli/get_parse_agnostic.py`` (reference get_parse_agnostic.py).
Host numpy and PIL::

    python -m hrviton_tpu_torch.cli.get_parse_agnostic --data_path ROOT/test \\
        --output_path ROOT/test/image-parse-agnostic-v3.2
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np


def main(argv=None):
    from PIL import Image

    from hrviton_tpu_torch.data.agnostic import build_parse_agnostic

    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True, help="dataset dir")
    p.add_argument("--output_path", required=True, help="output dir")
    args = p.parse_args(argv)

    os.makedirs(args.output_path, exist_ok=True)
    for im_name in sorted(os.listdir(osp.join(args.data_path, "image"))):
        pose_name = im_name.replace(".jpg", "_keypoints.json")
        try:
            with open(osp.join(args.data_path, "openpose_json", pose_name)) as f:
                pose_label = json.load(f)
            pose_data = np.array(
                pose_label["people"][0]["pose_keypoints_2d"]
            ).reshape((-1, 3))[:, :2]
        except (IndexError, FileNotFoundError):
            print(pose_name)
            continue

        parse_name = im_name.replace(".jpg", ".png")
        im_parse = Image.open(
            osp.join(args.data_path, "image-parse-v3", parse_name))
        agnostic = build_parse_agnostic(im_parse, pose_data,
                                        w=im_parse.width, h=im_parse.height)
        agnostic.save(osp.join(args.output_path, parse_name))


if __name__ == "__main__":
    main()
