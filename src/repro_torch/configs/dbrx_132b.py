"""dbrx-132b [moe] -- 16 experts top-4, fine-grained [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
The same config as ``repro/configs/dbrx_132b.py``.
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    n_experts=16,
    experts_per_tok=4,
    rope_theta=500000.0,
    source="hf:databricks/dbrx-base",
)
