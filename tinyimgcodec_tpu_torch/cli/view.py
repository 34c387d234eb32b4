"""CLI viewer: decode .img files to a matplotlib grid or PNG files."""

from __future__ import annotations

import argparse
import math
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="View/convert .img bitstreams.")
    p.add_argument("files", nargs="+", help=".img files to decode")
    p.add_argument(
        "--save", metavar="DIR",
        help="write decoded PNGs to DIR instead of opening a window",
    )
    p.add_argument("--backend", choices=["auto", "torch", "host"],
                   default="auto")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from PIL import Image

    from .. import api

    images = []
    for path in args.files:
        with open(path, "rb") as f:
            images.append((path, api.decompress(
                f.read(), args.backend, device=args.device)))

    if args.save:
        os.makedirs(args.save, exist_ok=True)
        for path, img in images:
            base = os.path.splitext(os.path.basename(path))[0] + ".png"
            out = os.path.join(args.save, base)
            Image.fromarray(img).save(out)
            print(out)
        return 0

    import matplotlib.pyplot as plt

    n = len(images)
    cols = math.ceil(math.sqrt(n))
    rows = math.ceil(n / cols)
    fig, axes = plt.subplots(rows, cols, squeeze=False)
    for ax in axes.flat:
        ax.axis("off")
    for ax, (path, img) in zip(axes.flat, images):
        ax.imshow(img, cmap="gray", vmin=0, vmax=255)
        ax.set_title(os.path.basename(path), fontsize=8)
    plt.tight_layout()
    plt.show()
    return 0


if __name__ == "__main__":
    sys.exit(main())
