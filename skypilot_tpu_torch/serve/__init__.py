"""Serving-side artifacts of the port (the LoRA adapter registry)."""
