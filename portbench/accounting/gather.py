"""Bytes and operations of the pixel-aligned bilinear gather (the
mathematics of ``models/encoder.py`` ``index_latent`` at bilinear/border):
each point reads its (up to) four corner rows of the latent table, its
corner record and weights, and writes one row. A table row counts once a
launch however many points read it; the caller, which cannot see the
points, counts the whole table, an upper bound on the rows they touch."""
from __future__ import annotations


def gather_bytes(points: int, channels: int, table_rows: int, in_bytes: int = 2, out_bytes: int = 2,
                 record_bytes: int = 16) -> int:
    """Bytes a gather of ``points`` points from a table of ``table_rows``
    rows must move: each table row once, one record of corner indices and
    weights a point, one output row a point."""
    return table_rows * channels * in_bytes + points * (record_bytes + channels * out_bytes)


def gather_flops(points: int, channels: int) -> int:
    """Operations of the bilinear lerp: three lerps of a channel, two each."""
    return 6 * points * channels
