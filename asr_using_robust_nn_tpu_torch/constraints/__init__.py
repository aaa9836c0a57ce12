from .engine import (  # noqa: F401
    Constraint,
    make_custom_constraint,
    make_fista_constraint,
    make_norm_constraint,
    make_simple_norm_constraint,
)
from .certify import (  # noqa: F401
    CertifyResult,
    certified_accuracy_curve,
    certified_radii,
    certify_sweep,
)
from .lipschitz import (  # noqa: F401
    get_lipschitz_constrained,
    get_lipschitz_sound,
    get_norms,
    get_upper_lipschitz,
    lipschitz_monitor,
)
