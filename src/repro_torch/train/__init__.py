"""Training: AdamW with its schedule and int8 error feedback, gradient
buckets, and the train steps (the single-program step and the explicit
ZeRO-2 step)."""
