"""The local mesh's collectives: every shard's collective seconds over its
wall seconds, summed over the window's calls (``mesh.last_run``), percent."""

from portbench.readers import shard_seconds


def read(record):
    got = shard_seconds(record)
    if got is None:
        return None
    wall, coll = got
    return 100.0 * sum(coll) / sum(wall)
