"""Parallelism of the port: collectives over torch process groups
(``parallel.collectives``), process-group set-up and batch sharding
(``parallel.mesh``), factor ownership (``parallel.partition``), and ring
and Ulysses attention (``parallel.ring_attention``, world=1 so far)."""
