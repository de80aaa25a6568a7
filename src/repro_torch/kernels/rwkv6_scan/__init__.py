from repro_torch.kernels.rwkv6_scan.ops import kernel_for, wkv6_op  # noqa: F401
from repro_torch.kernels.rwkv6_scan.ref import (wkv6_chunk_ref,  # noqa: F401
                                                wkv6_scan_ref)
