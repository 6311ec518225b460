"""Data-plane helpers of the port (the checkpoint manifest protocol)."""
