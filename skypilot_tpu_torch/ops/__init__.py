"""Port ops: norms and the paged-attention dispatch (kernel + plain)."""
from skypilot_tpu_torch.ops.norms import rms_norm

__all__ = ['rms_norm']
