"""User-level workflows of the port, run as
``python -m pymes_tpu_torch.examples.<name> --device cuda|cpu``; each
mirrors the JAX package's ``examples/<name>.py`` at the same defaults."""
