"""Test scaffolding of the port (no entry point imports it)."""
