"""xlstm-350m — alternating mLSTM + sLSTM blocks.

[arXiv:2405.04517; unverified]. 24L d_model=1024 4H vocab=50304, d_ff=0
(projections live inside the xLSTM blocks). O(1) recurrent state. Direct
descendant of the ALPINE paper's LSTM exploration.
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.xlstm import XlstmConfig

ARCH = ArchSpec(
    arch_id="xlstm_350m",
    family="ssm",
    module="xlstm",
    model_cfg=XlstmConfig(
        name="xlstm_350m", n_layers=24, d_model=1024, n_heads=4,
        vocab=50304, chunk=512),
    smoke_cfg=XlstmConfig(
        name="xlstm_350m_smoke", n_layers=4, d_model=32, n_heads=2,
        vocab=128, chunk=8),
    source="arXiv:2405.04517; unverified",
    supports_long=True,
)
