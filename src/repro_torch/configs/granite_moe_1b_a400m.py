"""granite-moe-1b-a400m [moe] -- 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8.  The
same config as ``repro/configs/granite_moe_1b_a400m.py``.
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    n_experts=32,
    experts_per_tok=8,
    rope_theta=10000.0,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
