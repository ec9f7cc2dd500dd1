"""The port's user-facing tools (counterparts of the repository's
``tools/`` scripts that import the JAX package): run each as
``python -m keystone_tpu_torch.tools.<name>``."""
