"""``api.compress(image, quality, precision=...)``: one host image in, one
stream out, on the current card (an image over ``pipeline.MAX_PIXELS`` goes
through ``parallel/tiled.py`` in block ranges)."""

KIND = "encode"


def setup(ctx):
    from tinyimgcodec_tpu_torch import api

    if ctx.config["images_per_call"] != 1:
        raise ValueError("api.compress takes one image a call")
    return {"api": api, "config": ctx.config, "device": ctx.device}


def call(state, images):
    c = state["config"]
    return [state["api"].compress(
        images[0], c["quality"], precision=c["precision"],
        block_index=c["block_index"], index_stride=c["index_stride"],
        device=state["device"])]
