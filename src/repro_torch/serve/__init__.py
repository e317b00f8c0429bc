"""Single-host continuous-batching serving on the port's model stack."""
