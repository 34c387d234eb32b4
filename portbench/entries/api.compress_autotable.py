"""``api.compress(image, quality, auto_generate_huffman_table=True)``: one
host image in, one stream out with Huffman tables built for that image, on
the current card.  The option is this entry's: a configuration has no key
for it."""

KIND = "encode"


def setup(ctx):
    from tinyimgcodec_tpu_torch import api

    if ctx.config["images_per_call"] != 1:
        raise ValueError("api.compress takes one image a call")
    return {"api": api, "config": ctx.config, "device": ctx.device}


def call(state, images):
    c = state["config"]
    return [state["api"].compress(
        images[0], c["quality"], auto_generate_huffman_table=True,
        precision=c["precision"], block_index=c["block_index"],
        index_stride=c["index_stride"], device=state["device"])]
