"""PyTorch + CUDA port of `asr_using_robust_nn_tpu` for NVIDIA Hopper GPUs.

The subpackages mirror the JAX package's layout and names:

  ops/       filters and f64 oracle (numpy), the plain fp32 MFCC pipeline
             (`mfcc_torch`), and the K1 kernel wrapper (`cuda_mfcc`) over
             the hand-written CUDA source in csrc/
  frontend/  `Frontend` dispatcher with int16-PCM ingress
  models/    the four MLP variants and parameter conversion from/to the JAX
             package's layout
  data/      1-s slicing and the fit-on-all scaler
  utils/     WAV decode/encode and resampling (numpy)
  serve/     the bucketed `InferenceEngine`

Importing the package imports no submodule; it never imports `jax` or the
JAX package.
"""
