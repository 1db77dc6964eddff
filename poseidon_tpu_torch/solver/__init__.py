"""Host-side exact solvers of the port (``oracle``: networkx network
simplex, the ``flow_solver="ssp"`` path)."""
