"""Architecture configs.  Importing this package registers each ``--arch``
id in :mod:`repro_torch.config.registry`; ``ASSIGNED`` lists the ten
architectures the dry run covers, in the JAX package's order."""
from repro_torch.configs import (deepseek_67b, h2o_danube3_4b,  # noqa: F401
                                 jamba_v01, mixtral_8x7b, paper_aes,
                                 phi4_mini, phi35_moe, pixtral_12b,
                                 qwen3_1p7b, rwkv6_1p6b, seamless_m4t_v2)

ASSIGNED = [
    "mixtral-8x7b",
    "phi3.5-moe-42b-a6.6b",
    "h2o-danube-3-4b",
    "qwen3-1.7b",
    "seamless-m4t-large-v2",
    "deepseek-67b",
    "phi4-mini-3.8b",
    "pixtral-12b",
    "jamba-v0.1-52b",
    "rwkv6-1.6b",
]
