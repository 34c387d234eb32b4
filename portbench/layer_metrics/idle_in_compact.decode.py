"""Share of the traced window in which a card idles while its host is in
``codec.decode.compact`` (the host-entropy leg's coefficients into the
narrow upload form), the mean over the cell's cards, percent."""

from portbench.program_spans import idle_in


def read(record):
    return idle_in(record, "decode", "compact")
