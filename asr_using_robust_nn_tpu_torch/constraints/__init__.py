from .engine import Constraint, make_simple_norm_constraint  # noqa: F401
