"""The decode pass's own work, from the configuration's shapes.

For a call of B streams of H x W images, nb = B * ceil(H / 8) *
ceil(W / 8) blocks:

- bytes: each stream read once (``stream_bytes``: header, payload and the
  TICX index), plus each image's true pixels written once, B * H * W
  (uint8);
- operations: the inverse 8x8 transform as two 8x8 matrix products a
  block, 2 * (8 * 8 * 8 multiply-adds) * 2 = 2048 a block, at the rate of
  the configuration's precision (exact: float64, the FP64 tensor cores;
  fast: float32).

Huffman decoding, dequantization and the crop are not counted, nor any
intermediate coefficient array: whatever kernels implement the pass, this
is the work it has to do.
"""

FLOPS_PER_BLOCK = 2 * (8 * 8 * 8) * 2
RATE = {"exact": "fp64_tensor_flop_s", "fast": "fp32_flop_s"}


def blocks(config: dict) -> int:
    return (config["images_per_call"] * -(-config["height"] // 8)
            * -(-config["width"] // 8))


def work(config: dict, stream_bytes: int) -> dict:
    pixels = config["images_per_call"] * config["height"] * config["width"]
    return {"bytes": stream_bytes + pixels,
            "flops": FLOPS_PER_BLOCK * blocks(config),
            "rate": RATE[config["precision"]]}
