"""IO: HTS labels and question sets, and Merlin linguistic features (the
port's own copies of gantts_tpu/io/)."""

from gantts_tpu_torch.io import hts, merlin  # noqa: F401
