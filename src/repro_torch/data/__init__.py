from repro_torch.data.packets import PacketTraceConfig, synth_packet_trace
from repro_torch.data.traffic import TrafficConfig, TrafficGenerator, merge_streams, prefetch
