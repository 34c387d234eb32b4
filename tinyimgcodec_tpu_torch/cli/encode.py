"""CLI encoder: any Pillow-readable image -> .img bitstream.

Prints the output size and the compression ratio, as the reference's
``encode.py`` does.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Compress a grayscale image to a .img bitstream."
    )
    p.add_argument("src", help="input image (any Pillow-supported format)")
    p.add_argument("dst", help="output .img path")
    p.add_argument("-q", "--quality", type=int, default=50)
    p.add_argument("--backend", choices=["auto", "torch", "host"],
                   default="auto")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument(
        "--dynamic-table", action="store_true",
        help="embed a frequency-optimal Huffman table",
    )
    p.add_argument(
        "--precision", choices=["exact", "fast"], default="exact",
        help="exact = byte-identical to the float64 reference",
    )
    p.add_argument(
        "--block-index", action="store_true",
        help="append the TICX trailer for parallel decode "
             "(~1.3%% larger; reference decoders ignore it)",
    )
    args = p.parse_args(argv)

    import numpy as np
    from PIL import Image

    from .. import api
    from ..config import CodecConfig

    config = CodecConfig(
        quality=args.quality,
        precision=args.precision,
        auto_huffman_table=args.dynamic_table,
        block_index=args.block_index,
    )
    image = np.asarray(Image.open(args.src).convert("L"))
    data = api.compress(image, backend=args.backend, config=config,
                        device=args.device)
    with open(args.dst, "wb") as f:
        f.write(data)
    ratio = image.size / len(data)
    print(f"{len(data)} bytes written ({ratio:.2f}:1 compression)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
