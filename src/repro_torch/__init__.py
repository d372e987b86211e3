"""PyTorch and CUDA port of ALEA-style sampled energy attribution.

Mirrors ``src/repro`` (the JAX reference) module by module: ``core`` holds
the profiler, the device pipeline and the numpy host modules;
``kernels`` holds the hand-written CUDA kernels for Hopper, each beside
its plain PyTorch version. Entry points run on the GPU unless the caller
passes ``device="cpu"``. Nothing here imports JAX or the reference.
"""
