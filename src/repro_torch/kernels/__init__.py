"""Hand-written CUDA kernels of the port and what surrounds them:

  fused_adam  — the D-Adam local step, one pass over the packed state
  gossip      — gossip_mix and gossip_adam_mix over the (K, rows, 128) state

pack.py is the tree <-> (rows, 128) bridge; ops.py dispatches each call by
the operand's device (CUDA kernel on the card, plain version on the CPU);
_build.py compiles ``csrc/`` with nvcc at first use; ref.py holds the
plain oracles.
"""
