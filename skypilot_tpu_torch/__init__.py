"""skypilot_tpu_torch: the PyTorch/CUDA port of the skypilot_tpu compute stack.

The package mirrors the layout and names of ``skypilot_tpu`` (the JAX
reference, which stays unchanged beside it) module by module, and runs
on one NVIDIA H100. It imports ``torch`` and never ``jax``, and nothing
of the JAX package: every helper it needs is its own copy.

Every TPU (Pallas) kernel on a ported path is a kernel written by hand
for Hopper (``sm_90a``) under ``csrc/``, built at first use by
``_build.py`` into ``build/torch_kernels/``. Each kernel's wrapper keeps
a plain PyTorch version beside it: a CPU tensor takes the plain version
(the tier-1 tests), a CUDA tensor launches the kernel or raises.

Entry points (``ContinuousBatchingEngine``, ``inference.server.main``,
``models.llama.init_params``) run on ``cuda`` unless the caller passes
``device='cpu'``; with no GPU present they raise.
"""
