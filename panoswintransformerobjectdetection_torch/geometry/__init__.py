from .axis import ew2ns, ns2we
from .sphere import haversine, make_uv_grid

__all__ = ["ew2ns", "ns2we", "haversine", "make_uv_grid"]
