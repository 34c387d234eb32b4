"""Of the window's ``codec.encode.table`` spans (one an auto-table
encode), the share whose image took the kernel route (count
``host_route`` 0), percent: an image sent to the host container codes its
payload on the host.  ``None`` where the window holds none."""

from portbench.program_spans import window_spans


def read(record):
    tables = [r for r in window_spans(record, "encode") or ()
              if r.name == "codec.encode.table" and "host_route" in r.counts]
    if not tables:
        return None
    return 100.0 * sum(r.counts["host_route"] == 0 for r in tables) / len(
        tables)
