"""repro_torch — the JJPF task-farm runtime on PyTorch and CUDA.

The port of the ``repro`` package: the same farm engine (lookup,
repository, leases, pool, scheduler, ``BasicClient``), the dense GQA
decoder models, and hand-written CUDA kernels for the attention hot
paths (``repro_torch.kernels``).  Entry points run on ``cuda:0`` unless
the caller asks for the CPU (``device="cpu"``), and raise when no GPU is
present and the CPU was not asked for (``repro_torch.device``).
"""
