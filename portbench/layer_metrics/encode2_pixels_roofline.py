"""The encode pass's least time (``work/encode_pass.py``, at the rate of
the configuration's precision) over the device time of the pixel-input
entropy kernel alone, ``encode2_kernel<false>`` by the profiler's name,
percent; ``None`` where the window holds no such launch.  In fast mode
that kernel runs the float32 transform and the entropy coding of every
block, so its time is most of the pass's device time."""

from portbench.readers import roofline

KERNEL = "encode2_kernel<false>"


def read(record):
    tl = record.get("timeline")
    if tl is None:
        return None
    ops = [op for op in tl["device_ops"]
           if op[4] == "kernel" and KERNEL in op[3]]
    return roofline(dict(record, timeline=dict(tl, device_ops=ops)),
                    "encode", "encode_pass")
