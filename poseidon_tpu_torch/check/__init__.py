"""Runtime checks of the port (the JAX package's ``check/`` counterpart).

``poseidon_tpu_torch.check.ledger`` holds the runtime ledgers — compile,
transfer and numerics budgets around warm rounds — in torch terms.  The
JAX package's static rules (posecheck: eight AST rules and their CLI)
have no port yet; this package imports none of them.
"""
