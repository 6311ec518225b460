"""Serving: the batch and continuous-batching engines and their HTTP
server.

Modules are imported explicitly (``from skypilot_tpu_torch.inference
import continuous``); nothing heavy loads with the package.
"""
