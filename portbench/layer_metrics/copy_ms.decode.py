"""Device time of the host-card copies of one decode call, summed over the
cards, milliseconds."""

from portbench.readers import copy_ms


def read(record):
    return copy_ms(record, "decode")
