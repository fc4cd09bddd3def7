"""recurrentgemma-9b [hybrid] -- RG-LRU + local attention, 1:2 pattern
[arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000.  Pattern
(rec, rec, local) repeating; local attention window 2048; RG-LRU width
d_rnn = 4096; temporal conv width 4.  The same config as
``repro/configs/recurrentgemma_9b.py``.
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    sliding_window=2048,
    layer_pattern=("rec", "rec", "local"),
    d_rnn=4096,
    conv_width=4,
    scale_embed=True,
    source="arXiv:2402.19427",
)
