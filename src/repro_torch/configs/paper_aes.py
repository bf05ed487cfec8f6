"""The paper's own benchmark function: AES encryption of a 600-byte input
(vSwarm [23,24]), deployed as a junctiond FaaS function.  On the card this
is the hand-written AES-128-CTR kernel (``repro_torch/csrc/aes_ctr.cu``)."""
from repro_torch.config import ArchConfig, ArchType, register


@register("paper-aes-600b")
def paper_aes() -> ArchConfig:
    return ArchConfig(
        name="paper-aes-600b",
        arch_type=ArchType.MICRO,
        citation="[vSwarm, arXiv this-paper §5]",
    )
