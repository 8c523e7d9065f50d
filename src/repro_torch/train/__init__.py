"""Training of the port: ``optimizer`` (AdamW), ``data`` (the synthetic
token stream), ``train_loop`` (the step), ``checkpoint`` (atomic
checkpoints) and ``fault_tolerance`` (the restart loop)."""
