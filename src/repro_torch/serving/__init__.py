from repro_torch.serving.packet_path import FlowEngine, PacketEngine, PathStats
from repro_torch.serving.pipeline import (
    LatencyReservoir,
    OctopusPipeline,
    PipelineConfig,
    PipelineStats,
    PipelineStepOutput,
)
