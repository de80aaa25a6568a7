from repro_torch.kernels.decode_attention.ops import decode_attention_op  # noqa: F401
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: F401
