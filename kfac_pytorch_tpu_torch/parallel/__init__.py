"""Sequence parallelism of the port: ring and Ulysses attention
(``parallel.ring_attention``), world=1 so far (``axis_name=None``)."""
