"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088].
SWA => long_500k runs."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe", num_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=32000,
    window=4096, act="swiglu", n_experts=8, top_k=2)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke", family="moe", num_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
    window=32, act="swiglu", n_experts=4, top_k=2,
    param_dtype="float32", dtype="float32")
