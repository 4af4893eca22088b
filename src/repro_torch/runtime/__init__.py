from repro_torch.runtime.config import POLICIES, RuntimeConfig
from repro_torch.runtime.plan import PlannedMatmul, RoutePlan
from repro_torch.runtime.quant import QuantScales, maybe_record, record_scales
from repro_torch.runtime.routing import (
    Route,
    RouteRecord,
    current_scope,
    mxu_utilization,
    name_scope,
    record_routes,
    route_matmul,
    systolic_utilization,
)
