"""Share of the traced window of encode calls with nothing on the card, the
mean over the cell's cards, percent."""

from portbench.readers import idle_pct


def read(record):
    return idle_pct(record, "encode")
