"""One image, its phrases -> boxes (and masks): the single-request command
line (port of reftr_tpu/cli/predict.py).

    python -m reftr_torch.cli.predict --preset refcoco_det \\
        --image photo.jpg --phrase "the red car" --phrase "a person" \\
        --resume <checkpoint, reference .pth, or URL> --output out.jpg

It takes every model flag of ``cli/main.py`` and ``--device`` ("cuda"
unless "cpu" is asked for). The weights come from ``--resume`` through
``train.loop.load_pretrained``, as the trainer's; without it the command
warns and predicts with a seeded init. Each phrase is one batch row over
the same image. It prints one JSON line per phrase, the box in the
original image's pixels (with ``--masks`` also the mask's area and
shape); ``--output`` draws the boxes on the image.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List


def get_args_parser() -> argparse.ArgumentParser:
    from reftr_torch.cli.main import get_args_parser as base_parser

    p = argparse.ArgumentParser("RefTR single-image prediction on PyTorch",
                                parents=[base_parser()])
    p.add_argument("--image", required=True, help="input image (JPEG/PNG)")
    p.add_argument("--phrase", action="append", required=True,
                   help="referring expression (repeatable)")
    p.add_argument("--output", default="",
                   help="write the image with the predicted boxes drawn here")
    return p


def predict(args: argparse.Namespace) -> List[dict]:
    from reftr_torch.cli.main import args_to_config
    from reftr_torch.data.datasets import _load_image
    from reftr_torch.serve import ServingModel, answer, box_pixels
    from reftr_torch.tools.serve import Frontend
    from reftr_torch.train.loop import build_tokenizer

    cfg = args_to_config(args)
    img = _load_image(args.image)
    # the server's rows: one per phrase over the same canvas
    req = Frontend(cfg, build_tokenizer(cfg)).rows(img, list(args.phrase))
    if not cfg.train.resume:
        print("WARNING: no --resume checkpoint; predicting with random "
              "weights", file=sys.stderr)
    model = ServingModel(cfg, req.k, device=args.device,
                         resume=cfg.train.resume)
    out = model(req.rows)
    if args.output:
        from reftr_torch.tools.visualize import draw_boxes

        draw_boxes(img, box_pixels(out["pred_boxes"], req.orig_hw)).save(
            args.output, quality=92)
    return answer(req, out)


def main(argv=None) -> int:
    from reftr_torch.cli.presets import apply_preset

    args = get_args_parser().parse_args(argv)
    if args.preset:
        apply_preset(args, args.preset, argv)
    for r in predict(args):
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
