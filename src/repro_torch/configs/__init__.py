"""Architecture configs.  Importing this package registers each ``--arch``
id in :mod:`repro_torch.config.registry`."""
from repro_torch.configs import (deepseek_67b, h2o_danube3_4b,  # noqa: F401
                                 jamba_v01, mixtral_8x7b, paper_aes,
                                 phi4_mini, phi35_moe, pixtral_12b,
                                 qwen3_1p7b, rwkv6_1p6b, seamless_m4t_v2)
