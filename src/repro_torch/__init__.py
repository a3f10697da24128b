"""PyTorch/CUDA port of the FT-Transformer reproduction.

Mirrors the layout of the JAX package ``repro`` (``configs/ core/ kernels/
models/ serve/ ft_runtime/ launch/``) and keeps its function names, so a
reader finds each counterpart where they expect it. This package imports
``torch`` and numpy only; it never imports JAX or the JAX package. Its
entry points run on an NVIDIA GPU (``device="cuda"``) unless the caller asks
for the CPU, where every CUDA kernel's wrapper runs the kernel's plain
PyTorch version instead.
"""
