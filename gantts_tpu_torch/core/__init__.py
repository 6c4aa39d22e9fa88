"""Device math shared by the models and the training step."""

from gantts_tpu_torch.core.masking import masked_mse_loss, sequence_mask  # noqa: F401
from gantts_tpu_torch.core.paramgen import (  # noqa: F401
    multi_stream_mlpg,
    unit_variance_mlpg,
)
from gantts_tpu_torch.core.streams import (  # noqa: F401
    get_static_features,
    get_static_stream_sizes,
    select_streams,
)
