"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense", num_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=128256,
    rope_theta=500000.0, act="swiglu")

SMOKE = ModelConfig(
    name="llama3-8b-smoke", family="dense", num_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
    rope_theta=500000.0, act="swiglu", param_dtype="float32",
    dtype="float32")
