"""Tuning: the bucket-edge policies (the cost model and autotuner wait for
the tuning slice of the port)."""
