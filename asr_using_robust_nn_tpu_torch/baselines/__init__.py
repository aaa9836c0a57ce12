"""The port's counterparts of the repo's `baselines/` studies
(`accuracy_study`); run as `python -m
asr_using_robust_nn_tpu_torch.baselines.<name>`."""
