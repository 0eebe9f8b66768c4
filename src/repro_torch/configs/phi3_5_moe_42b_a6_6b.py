"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct]. 16 experts divide model=16 => true EP."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", num_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=6400, vocab_size=32064,
    act="swiglu", n_experts=16, top_k=2)

SMOKE = ModelConfig(
    name="phi3.5-moe-42b-smoke", family="moe", num_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
    act="swiglu", n_experts=4, top_k=2, param_dtype="float32",
    dtype="float32")
