"""The decode pass's least time (``work/decode_pass.py``) over the device
time of every kernel, memset and on-card copy of the window, percent."""

from portbench.readers import roofline


def read(record):
    return roofline(record, "decode", "decode_pass")
