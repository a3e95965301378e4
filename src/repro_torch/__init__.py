"""PyTorch / CUDA port of the accelerator half of the HotRAP reproduction.

`repro_torch` mirrors the module layout of `repro` (the JAX package,
which stays the reference) for four slices: serving (the RALT hotness
tracker, the tiered paged KV cache, the attention-only decoder models
and the lockstep serving engine), training and prefill (forward and
loss, AdamW, the data pipeline, checkpoints, the train and prefill steps
and the training launcher), the attention-free Mamba2 family (its mixer
and decode step on all of those paths), and the MoE family with the
tiered embedding and expert caches.  The four Pallas kernels
of the reference are rewritten by hand in CUDA C++ for Hopper (`csrc/`),
built with `nvcc` at first use and bound with `ctypes`
(`kernels/_build.py`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA they raise instead of carrying on on the CPU.  Each kernel
wrapper dispatches on the tensor's device: a CUDA tensor launches the
hand-written kernel, a CPU tensor runs the plain PyTorch version.

The package imports torch and numpy only: no jax and nothing of `repro`.
"""
from .device import resolve_device  # noqa: F401
