"""Megabytes (10^6 bytes) of host arrays copied into tensors a
localization query: the port's ``upload_bytes`` counter over the traced
queries, divided by the queries."""

from gsbench import program_records


def read(ctx, st, window):
    return program_records.per_query(ctx, "upload_bytes", 1e-6)
