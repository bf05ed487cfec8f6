"""Architecture configs ported so far.  Importing this package registers
each ``--arch`` id in :mod:`repro_torch.config.registry`; the other
families arrive with their model code."""
from repro_torch.configs import paper_aes, qwen3_1p7b  # noqa: F401
