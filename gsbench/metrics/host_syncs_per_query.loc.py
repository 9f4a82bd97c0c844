"""Host syncs a localization query: the port's ``host_sync/<site>``
counters over the traced queries (each a value read to the host, or on the
card an operation that waits for the device though it reads nothing),
divided by the queries."""

from gsbench import program_records


def read(ctx, st, window):
    return program_records.per_query(ctx, "host_sync/")
