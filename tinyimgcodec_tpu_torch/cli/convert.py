"""CLI fixture converter: image -> raw grayscale bytes.

Prepares raw pixel streams for the embedded encoder
(``python -m tinyimgcodec_tpu_torch.cli.convert photo.png - |
tic_embedded_encode 512 512 2 > out.img``).  Runs on the host only.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert an image to raw grayscale bytes."
    )
    p.add_argument("src", help="input image (any Pillow-supported format)")
    p.add_argument("dst", help="output raw file, or - for stdout")
    p.add_argument(
        "--resize", type=int, default=None, metavar="N",
        help="resize to NxN first",
    )
    args = p.parse_args(argv)

    import numpy as np
    from PIL import Image

    img = Image.open(args.src).convert("L")
    if args.resize:
        img = img.resize((args.resize, args.resize))
    data = np.asarray(img).tobytes()
    if args.dst == "-":
        sys.stdout.buffer.write(data)
    else:
        with open(args.dst, "wb") as f:
            f.write(data)
        h, w = np.asarray(img).shape
        print(f"{w}x{h}, {len(data)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
