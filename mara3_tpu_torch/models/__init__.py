"""Physical models driving the subprograms: two_body on the host,
two_body_device on tensors of the run's device."""
