"""The port's copy of the JAX package's ``cluster`` package: placement
(``topology``), the broadcast envelope (``broadcast``), generation tokens
(``generations``) and the node-to-node HTTP client (``client``)."""
