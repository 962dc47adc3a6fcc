"""Reference-format checkpoints: the reference PyTorch models' state_dicts
to and from the port's (``torch_import``, ``torch_export``)."""
