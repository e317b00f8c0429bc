"""Continuous-batching serving on the port's model stack: the engine, its KV
ledger and the tensor-parallel decode step."""
