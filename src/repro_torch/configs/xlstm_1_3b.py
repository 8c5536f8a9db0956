"""xlstm-1.3b [ssm] - sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].
48L d_model=2048 4H d_ff=0 vocab=50304.

Block ratio 7:1 mLSTM:sLSTM (the paper's xLSTM[7:1]); 48 = 6 x period-8
groups, cleanly scanned. d_ff=0: xLSTM blocks carry their own projections,
no separate FFN. Sub-quadratic: runs long_500k (O(1) recurrent state).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm_1_3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    head_dim=512,
    rope_kind="none",
    block_pattern=("mlstm",) * 7 + ("slstm",),
)
