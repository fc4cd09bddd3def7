"""rwkv6-3b [ssm] -- Finch, data-dependent decay, attention-free
[arXiv:2404.05892].

32L d_model=2560 (attn-free) d_ff=8960 vocab=65536.  Head size 64
(RWKV convention) -> 40 wkv heads.  The same config as
``repro/configs/rwkv6_3b.py``.
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,           # d_model / rwkv_head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    rwkv_head_dim=64,
    time_decay_extra_dim=64,
    pos_type="none",
    source="arXiv:2404.05892",
)
