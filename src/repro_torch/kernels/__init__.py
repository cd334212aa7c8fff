"""Hand-written CUDA kernels of the port and what surrounds them:

  fused_adam  — the D-Adam local step, one pass over the packed state
  gossip      — gossip_mix, gossip_adam_mix and consensus_mix over the
                (K, rows, 128) state
  sign_compress — CD-Adam's error-feedback sign compression (stacked,
                per leaf segment, and single-scale)

pack.py is the tree <-> (rows, 128) bridge; ops.py dispatches each call by
the operand's device (CUDA kernel on the card, plain version on the CPU);
_build.py compiles ``csrc/`` with nvcc at first use; ref.py holds the
plain oracles.
"""
