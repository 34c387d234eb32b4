"""The local mesh's slowest shard: its wall seconds summed over the
window's calls, over the mean shard's (``mesh.last_run``), percent."""

from portbench.readers import shard_seconds


def read(record):
    got = shard_seconds(record)
    if got is None:
        return None
    wall, _ = got
    return 100.0 * max(wall) / (sum(wall) / len(wall))
