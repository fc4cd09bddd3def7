"""qwen2-vl-72b [vlm] -- M-RoPE, dynamic resolution [arXiv:2409.12191].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.  The ViT vision
encoder and projector are stubbed: ``vision_tokens`` precomputed patch
embeddings prefix the text sequence and M-RoPE consumes (temporal, height,
width) position ids.  The same config as ``repro/configs/qwen2_vl_72b.py``.
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    pos_type="mrope",
    rope_theta=1000000.0,
    vision_tokens=256,
    source="arXiv:2409.12191",
)
