from .whitebox import fgsm  # noqa: F401
