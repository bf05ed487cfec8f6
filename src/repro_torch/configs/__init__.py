"""Architecture configs ported so far.  Importing this package registers
each ``--arch`` id in :mod:`repro_torch.config.registry`; the other
families arrive with their model code."""
from repro_torch.configs import (deepseek_67b, h2o_danube3_4b,  # noqa: F401
                                 mixtral_8x7b, paper_aes, phi4_mini,
                                 phi35_moe, qwen3_1p7b)
