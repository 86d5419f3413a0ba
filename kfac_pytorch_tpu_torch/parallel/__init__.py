"""Parallelism of the port: collectives over torch process groups
(``parallel.collectives``), process-group set-up, the data x seq grid
and batch sharding (``parallel.mesh``), factor ownership
(``parallel.partition``), and ring and Ulysses attention over a process
group (``parallel.ring_attention``)."""
