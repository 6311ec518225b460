"""Serving: the continuous-batching engine and its HTTP server.

Modules are imported explicitly (``from skypilot_tpu_torch.inference
import continuous``); nothing heavy loads with the package.
"""
