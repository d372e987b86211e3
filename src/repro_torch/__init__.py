"""PyTorch and CUDA port of ALEA-style sampled energy attribution.

Mirrors ``src/repro`` (the JAX reference) module by module: ``core`` holds
the profiler, the device pipeline, regions and the numpy host modules;
``configs`` the model configurations; ``models`` the dense transformer
(prefill and decode); ``kernels`` the hand-written CUDA kernels for
Hopper, each beside its plain PyTorch version. Entry points run on the GPU unless the caller
passes ``device="cpu"``. Nothing here imports JAX or the reference.
"""
