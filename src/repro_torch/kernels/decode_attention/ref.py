"""Oracle for decode attention (re-exported from flash_attention.ref)."""
from repro_torch.kernels.flash_attention.ref import decode_attention_ref  # noqa: F401
