"""qwen3-14b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-14B family]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense", num_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=17408, vocab_size=151936,
    head_dim=128, qk_norm=True, rope_theta=1000000.0, act="swiglu")

SMOKE = ModelConfig(
    name="qwen3-14b-smoke", family="dense", num_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
    qk_norm=True, act="swiglu", param_dtype="float32", dtype="float32")
