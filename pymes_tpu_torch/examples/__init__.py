"""User-level workflows of the port, run as
``python -m pymes_tpu_torch.examples.<name> [--device cpu]``: each is the
JAX package's ``examples/<name>.py`` with the import root changed, at the
same defaults, on the card unless the caller asks for the CPU."""
