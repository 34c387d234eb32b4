"""The 95th percentile of the decode calls' times, host clock, from the call
to its return with the answer in host memory."""

from portbench.readers import p95_ms


def read(record):
    return p95_ms(record, "decode")
