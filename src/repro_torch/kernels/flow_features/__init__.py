from repro_torch.kernels.flow_features.ops import (
    FLOW_UPDATE,
    HIST,
    META,
    META_WIDTH,
    MICRO_OPS,
    apply_alu_program,
    check_program,
    default_program,
    default_program_np,
    flow_feature_update,
    flow_feature_update_plain,
    fold_features,
)
