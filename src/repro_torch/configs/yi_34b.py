"""yi-34b [dense] -- llama-arch GQA [arXiv:2403.04652].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.  The same config as
``repro/configs/yi_34b.py``.
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    rope_theta=5000000.0,
    source="arXiv:2403.04652",
)
