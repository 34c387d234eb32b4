"""True-image megapixels of every decode call that returned in the window,
over the window's seconds."""

from portbench.readers import rate_mp_s


def read(record):
    return rate_mp_s(record, "decode")
