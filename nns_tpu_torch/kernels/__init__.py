from nns_tpu_torch.kernels.oracle import (  # noqa: F401
    linear_scan,
    nn_oracle_f64,
    recall_at_1,
)
from nns_tpu_torch.kernels.fused import (  # noqa: F401
    FusedBruteForce,
    fused_fallback,
    fused_min_idx,
    fused_min_idx_plain,
    nns_fused,
    prepare_refs,
)
from nns_tpu_torch.kernels.fused_ladder import (  # noqa: F401
    fused_point_major_min_idx,
    fused_queries_resident_min_idx,
    fused_streaming_min_idx,
    nns_fused_point_major,
    nns_fused_queries_resident,
    nns_fused_streaming,
    nns_two_level,
    two_level_min_idx,
)
from nns_tpu_torch.kernels.xla_bruteforce import (  # noqa: F401
    nns_distance_matrix,
    nns_expansion_matmul,
)
from nns_tpu_torch.kernels.mxu_expansion import (  # noqa: F401
    MXUExpansion,
    nns_mxu_expansion,
    phase1,
    phase1_plain,
)
from nns_tpu_torch.kernels.cell_list import (  # noqa: F401
    CellListEngine,
    cell_scan,
    cell_scan_plain,
    nns_cell_list,
)
