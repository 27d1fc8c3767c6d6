"""Physical models driving the subprograms (host-side)."""
