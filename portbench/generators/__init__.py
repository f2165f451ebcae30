"""Frozen instance generators: ``generate(size, order_seed)`` returns a
FlatZinc text whose constraints are written in an order drawn from
``order_seed``; the model and its answers do not depend on it."""
