"""whisper-medium [audio] -- enc-dec, conv frontend (stub) [arXiv:2212.04356].

24L (decoder) d_model=1024 16H d_ff=4096 vocab=51865; 24 encoder layers;
1500 encoder frames (30 s of audio after the stubbed conv frontend).
Whisper uses full multi-head attention (kv = 16 = heads).  The same config
as ``repro/configs/whisper_medium.py``.
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    encoder_layers=24,
    encoder_seq=1500,
    pos_type="learned",
    norm_eps=1e-5,
    source="arXiv:2212.04356",
)
