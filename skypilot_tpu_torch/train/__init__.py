"""Training: the loss, the AdamW train step and the pretraining entry point.

Modules are imported explicitly (``from skypilot_tpu_torch.train import
step``); nothing heavy loads with the package.
"""
