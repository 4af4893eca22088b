from repro_torch.runtime.config import POLICIES, RuntimeConfig
from repro_torch.runtime.routing import (
    Route,
    RouteRecord,
    mxu_utilization,
    name_scope,
    record_routes,
    route_matmul,
    systolic_utilization,
)
