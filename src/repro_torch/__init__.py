"""PyTorch/CUDA port of the decentralized adaptive optimizers (D-Adam).

A second package beside the JAX reference ``repro``: the same layout and
names, written in PyTorch, with every TPU kernel of the ported path
rewritten by hand in CUDA C++ for Hopper (``csrc/``). It imports neither
``jax`` nor ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise instead of falling back to the CPU. On a CPU
tensor each kernel wrapper runs its plain PyTorch version.
"""
