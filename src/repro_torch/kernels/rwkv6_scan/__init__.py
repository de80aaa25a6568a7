from repro_torch.kernels.rwkv6_scan.ops import (WKV6Fn, kernel_for,  # noqa: F401
                                                wkv6_bwd_op, wkv6_op)
from repro_torch.kernels.rwkv6_scan.ref import (wkv6_bwd_chunk_ref,  # noqa: F401
                                                wkv6_bwd_ref, wkv6_chunk_ref,
                                                wkv6_scan_ref)
