// The D-Adam half-step of one element (Alg. 1 lines 4-6, no bias
// correction), shared by fused_adam.cu and gossip.cu.
//
// The operations and their order are those of the TPU kernel
// (src/repro/kernels/fused_adam.py:_adam_kernel), in f32:
//   g += wd * p;  m = b1*m + (1-b1)*g;  v = b2*v + ((1-b2)*g)*g;
//   p -= (eta*m) / (sqrt(v) + tau),  or (eta*m) * rsqrt(v + 1e-30) at tau == 0.
// The constants arrive as f32 values that the host rounded from doubles
// (1-b1 and 1-b2 included), as JAX's closure constants are. The sources
// are built without FMA contraction (-fmad=false), so each product and sum
// rounds as in the plain PyTorch version, which runs one op at a time.
//
// The parameter buffer (p, g) and the moments (m, v) are each f32 or bf16
// (a model's param_dtype; make_optimizer(moment_dtype=)): a bf16 operand is
// widened to f32 on load (exact), the step is computed in f32, and each
// output is rounded once, at the store, to its own dtype, to nearest-even
// (dtype.cuh), as the TPU kernel's .astype and the plain version's .to do.
#pragma once

#include "dtype.cuh"

struct AdamConsts {
  float eta, beta1, one_minus_beta1, beta2, one_minus_beta2, tau, weight_decay;
};

__device__ __forceinline__ void adam_half_step(float p, float g, float m,
                                               float v, const AdamConsts& c,
                                               float* po, float* mo,
                                               float* vo) {
  if (c.weight_decay != 0.0f) g = g + c.weight_decay * p;
  m = c.beta1 * m + c.one_minus_beta1 * g;
  v = c.beta2 * v + c.one_minus_beta2 * g * g;
  float step = (c.tau == 0.0f) ? c.eta * m * rsqrtf(v + 1e-30f)
                               : c.eta * m / (sqrtf(v) + c.tau);
  *po = p - step;
  *mo = m;
  *vo = v;
}
