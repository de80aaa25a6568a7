from repro_torch.kernels.rwkv6_scan.ops import wkv6_op  # noqa: F401
from repro_torch.kernels.rwkv6_scan.ref import wkv6_scan_ref  # noqa: F401
