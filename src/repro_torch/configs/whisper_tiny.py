"""whisper-tiny [audio] — enc-dec backbone, conv frontend STUB
[arXiv:2212.04356]. 4 encoder + 4 decoder layers; vocab padded
51865 -> 51872 for tensor-parallel divisibility."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec", num_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab_size=51872,
    act="gelu", n_encoder_layers=4)

SMOKE = ModelConfig(
    name="whisper-tiny-smoke", family="encdec", num_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
    act="gelu", n_encoder_layers=2, param_dtype="float32",
    dtype="float32")
