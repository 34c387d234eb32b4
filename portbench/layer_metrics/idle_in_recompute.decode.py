"""Share of the traced window in which a card idles while its host is in
``codec.decode.recompute`` (the float64 recompute of the flagged blocks), the
mean over the cell's cards, percent; ``flagged_blocks``: the blocks
recomputed a call, summed over the shards."""

from portbench.program_spans import idle_in, per_call


def read(record):
    got = idle_in(record, "decode", "recompute")
    if got is not None:
        got["flagged_blocks"] = per_call(record, "decode",
                                         "codec.decode.recompute", "flagged")
    return got
