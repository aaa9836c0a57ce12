"""The thesis study on the port: the counterparts of the repo's
`examples/` scripts (hard corpora, the demo, the synthetic and speaker
robustness studies, the hardness sweep). Each module with a `main(argv)`
runs as `python -m asr_using_robust_nn_tpu_torch.examples.<name>`; nothing
runs at import time."""
