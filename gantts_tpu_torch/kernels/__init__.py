"""Hand-written CUDA kernels for Hopper, built from ``csrc/`` at first use.

Importing this package needs no CUDA toolkit: a kernel library is built and
loaded the first time a CUDA tensor reaches one of its wrappers.
"""

from gantts_tpu_torch.kernels.linear_scan import (  # noqa: F401
    linear_recurrence,
)
from gantts_tpu_torch.kernels.lstm_scan import (  # noqa: F401
    fused_bilstm_proj_layer,
    fused_lstm_layer,
    fused_lstm_proj_layer,
    lstm_proj_layer,
)
from gantts_tpu_torch.kernels.sru_scan import (  # noqa: F401
    fused_sru_layer,
    fused_sru_proj_layer,
    launch_counts,
    reset_launch_counts,
)
