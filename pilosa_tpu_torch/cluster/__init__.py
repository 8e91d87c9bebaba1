"""The port's share of the JAX package's ``cluster`` package: only the
generation tokens one node keys its caches on (``generations``)."""
