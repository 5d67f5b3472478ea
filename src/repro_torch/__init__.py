"""PyTorch and CUDA port of the event-driven task runtime.

The port of the JAX package ``repro`` to an NVIDIA H100: the polyhedral
front end, index graphs and wavefront leveling (NumPy, copied), the
counted-sync device sweeps and fused stencil execution (torch), and the
hand-written CUDA kernel of the wavefront step (``csrc/``).  It imports
neither JAX nor ``repro``.  Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""
