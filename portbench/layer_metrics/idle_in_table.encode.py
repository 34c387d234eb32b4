"""Share of the traced window in which a card idles while its host is in
``codec.encode.table`` (the auto-table encode's DPCM, histograms, table
build and route), the mean over the cell's cards, percent."""

from portbench.program_spans import idle_in


def read(record):
    return idle_in(record, "encode", "table")
