"""PyTorch and CUDA port of the event-driven task runtime.

The port of the JAX package ``repro`` to an NVIDIA H100: the polyhedral
front end, index graphs and wavefront schedules (NumPy, copied); the
paper's six synchronization models on the instrumented simulator, their
Table-2 overhead atlas, the threaded autodec runtime and the
generated-code emitters (host code, copied); the counted-sync device
sweeps, fused stencil execution and the distributed rank engine
(``core.edt.run_distributed``: rank-owned task ranges with message
decrements, its device engine stepping every rank on the card);
the serving path of the dense, RWKV6 and hybrid (Mamba2 + shared
attention) model families (``models``, ``launch``); and the hand-written
CUDA kernels of the wavefront step, flash attention, WKV6 and the SSD
scan (``csrc/``).  It imports neither JAX nor ``repro``.  Entry points
run on CUDA unless the caller passes ``device="cpu"``.
"""
