"""Images the decode kernel leg returned over the images of the window's
``codec.decompress_batch`` calls (their leg counts), percent: an image that
falls to a host leg is work wasted on the card."""

from portbench.program_spans import decode_leg_share


def read(record):
    return decode_leg_share(record, "kernel")
