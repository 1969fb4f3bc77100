"""Device time a request in PyTorch's own operations and the CUDA
runtime's: ATen's elementwise, reduction, index and scan kernels, CUB's
scans, cuBLAS's GEMMs, copies and fills, summed over the traced window's
cards and averaged over its completed requests, in ms.

An operation is told by what belongs to PyTorch and CUDA, never by the
program's kernel names: a kernel the program adds later counts as its
own, and the work it takes over leaves this metric."""

import re

# a kernel's qualified name as the profiler gives it, after ``void ``
LIBRARY_KERNEL = re.compile(
    r"^(?:void\s+)?(?:at::|at_cuda_detail::|cub::|c10::|cublas)"
    r"|^sm\d+_xmma_|_cublas$")
RUNTIME_OP = ("Memcpy", "Memset")


def is_plain_torch(name):
    return name.startswith(RUNTIME_OP) or bool(LIBRARY_KERNEL.search(name))


def read(rec):
    tl = rec.timeline
    if tl is None or not rec.requests:
        return None
    return 1e3 * tl.kernel_seconds(is_plain_torch) / rec.requests
