"""Share of the traced window in which a card idles while its host is in no
``codec.encode.*`` stage (Python between stages, the call alone, between
calls), the mean over the cell's cards, percent."""

from portbench.program_spans import UNSTAGED, idle_in


def read(record):
    return idle_in(record, "encode", UNSTAGED)
