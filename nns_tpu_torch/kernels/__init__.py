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
from nns_tpu_torch.kernels.cell_list import (  # noqa: F401
    CellListEngine,
    cell_scan,
    cell_scan_plain,
    nns_cell_list,
)
