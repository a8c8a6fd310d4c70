"""Example drivers of the port, the counterparts of the JAX package's
twelve ``examples/*.py``.  Run one as

    python -m dominantsparseeigenad_tpu_torch.examples.<name> [--device cpu]

Each takes its JAX twin's arguments and defaults plus ``--device``
(default ``cuda``: without a card it raises, it never falls back to the
CPU), prints the same lines, and has a ``main(argv=None)`` that returns
the numbers it printed.  Importing a driver parses no arguments and
touches no device.
"""
