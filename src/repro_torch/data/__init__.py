from repro_torch.data.traffic import TrafficConfig, TrafficGenerator
