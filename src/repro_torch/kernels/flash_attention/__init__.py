from repro_torch.kernels.flash_attention.ops import flash_attention_op  # noqa: F401
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: F401
