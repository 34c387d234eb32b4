"""The encode pass's own work, from the configuration's shapes.

For a call of B images of H x W (``images_per_call``, ``height``,
``width``), nb = B * ceil(H / 8) * ceil(W / 8) blocks:

- bytes: each image's true pixels read once, B * H * W (uint8), plus each
  stream written once (``stream_bytes``: header, payload and TICX trailer,
  as the reference writes them for these inputs), plus each image's start
  offset written once, 4 * B;
- operations: the forward 8x8 transform as two 8x8 matrix products a
  block, 2 * (8 * 8 * 8 multiply-adds) * 2 = 2048 a block, at the rate of
  the configuration's precision (exact: float64, the FP64 tensor cores;
  fast: float32).

Quantization, zig-zag, Huffman symbols and placement are not counted,
nor any intermediate row, coefficient pull or fill: whatever kernels
implement the pass, this is the work it has to do.  Corpus, 49 images of
512 x 512: 200 704 blocks, 12 845 056 pixel bytes, 411 041 792 operations.
"""

FLOPS_PER_BLOCK = 2 * (8 * 8 * 8) * 2
RATE = {"exact": "fp64_tensor_flop_s", "fast": "fp32_flop_s"}


def blocks(config: dict) -> int:
    return (config["images_per_call"] * -(-config["height"] // 8)
            * -(-config["width"] // 8))


def work(config: dict, stream_bytes: int) -> dict:
    b = config["images_per_call"]
    pixels = b * config["height"] * config["width"]
    return {"bytes": pixels + stream_bytes + 4 * b,
            "flops": FLOPS_PER_BLOCK * blocks(config),
            "rate": RATE[config["precision"]]}
