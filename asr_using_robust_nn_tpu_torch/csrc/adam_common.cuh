// The Adam rule shared by the fused training kernels (fused_epoch.cu,
// fused_step.cu): Keras' constants arrive in AdamArgs, the step count lives
// in device memory, and b^t is formed as exp(t * log b).

#pragma once

#include <cuda_runtime.h>

// Adam's constants, passed by pointer from the host and by value to kernels.
// Outside any namespace: the exported C entries take it.
struct AdamArgs {
  float lr, b1, b2, omb1, omb2, eps, logb1, logb2;
};

// Bias corrections of Adam step t = count[0] + step + 1.
__device__ __forceinline__ void bias_corrections(const int* count, int step,
                                                 const AdamArgs& a, float& bc1,
                                                 float& bc2) {
  const float t = static_cast<float>(count[0] + step + 1);
  bc1 = 1.f - expf(t * a.logb1);
  bc2 = 1.f - expf(t * a.logb2);
}

__device__ __forceinline__ void adam_step(float& p, float& m, float& v,
                                          float g, float bc1, float bc2,
                                          const AdamArgs& a) {
  const float mn = a.b1 * m + a.omb1 * g;
  const float vn = a.b2 * v + a.omb2 * g * g;
  const float upd = (mn / bc1) / (sqrtf(vn / bc2) + a.eps);
  p = p - a.lr * upd;
  m = mn;
  v = vn;
}
