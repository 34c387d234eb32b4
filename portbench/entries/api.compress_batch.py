"""``api.compress_batch(images, quality, precision=...)``: a batch of host
images in, one TICX-indexed stream an image out, on the current card."""

KIND = "encode"


def setup(ctx):
    from tinyimgcodec_tpu_torch import api

    return {"api": api, "config": ctx.config, "device": ctx.device}


def call(state, images):
    c = state["config"]
    return state["api"].compress_batch(
        images, c["quality"], precision=c["precision"],
        block_index=c["block_index"], index_stride=c["index_stride"],
        device=state["device"])
