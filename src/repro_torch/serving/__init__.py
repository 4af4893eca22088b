from repro_torch.serving.packet_path import (
    FlowEngine,
    FlowPath,
    PacketEngine,
    PacketPath,
    PathStats,
)
from repro_torch.serving.pipeline import (
    InflightDispatch,
    LatencyReservoir,
    OctopusPipeline,
    PipelineConfig,
    PipelineStats,
    PipelineStepOutput,
)
from repro_torch.serving.engine import Request, ServeConfig, ServeEngine, ServeStats
from repro_torch.serving.sharded import LANE_BACKENDS, ShardedOctopusPipeline
from repro_torch.serving.service import (
    ADMISSION_POLICIES,
    ClientStats,
    OctopusService,
    Rejected,
    ServeResult,
    ServiceConfig,
    ServiceStats,
    serve_stream,
)
