"""Share of the traced window in which a card idles while its host is in
``codec.decode.host_entropy`` (the C decodes of the host-entropy leg, one
thread a stream), the mean over the cell's cards, percent."""

from portbench.program_spans import idle_in


def read(record):
    return idle_in(record, "decode", "host_entropy")
