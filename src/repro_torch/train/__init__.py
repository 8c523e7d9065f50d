"""Training of the port: ``optimizer`` (AdamW), ``data`` (the synthetic
token stream) and ``train_loop`` (the step)."""
