"""gemma3-1b [dense] -- 5:1 local:global attention [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144; head_dim 256;
sliding window 512 on local layers; tied embeddings; sqrt(d) embed scaling.
The same config as ``repro/configs/gemma3_1b.py``.
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262144,
    head_dim=256,
    sliding_window=512,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    rope_theta=1000000.0,
    scale_embed=True,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
