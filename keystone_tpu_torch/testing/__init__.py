"""Test scaffolding of the port: seeded data writers, the numpy JPEG
encoder, and the chaos harness (``faults``, ``chaos``), which the tool
``python -m keystone_tpu_torch.tools.chaos_run`` drives."""
