"""``api.decompress_batch(streams, precision=...)``: a batch of streams in,
a (B, H, W) uint8 host array out, on the current card."""

KIND = "decode"


def setup(ctx):
    from tinyimgcodec_tpu_torch import api

    return {"api": api, "config": ctx.config, "device": ctx.device}


def call(state, streams):
    return state["api"].decompress_batch(
        streams, precision=state["config"]["precision"],
        device=state["device"])
