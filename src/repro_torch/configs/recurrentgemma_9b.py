"""recurrentgemma-9b [hybrid] — RG-LRU + local attention 1:2
[arXiv:2402.19427]. Pattern (rec, rec, attn) cycled over 38 layers; local
attention window 2048, MQA kv=1. Sub-quadratic => long_500k runs."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", num_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, d_ff=12288, vocab_size=256000,
    window=2048, act="geglu", block_pattern=("rec", "rec", "attn"),
    lru_width=4096, ssm_conv=4)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke", family="hybrid", num_layers=3,
    d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab_size=256,
    window=32, act="geglu", block_pattern=("rec", "rec", "attn"),
    lru_width=64, ssm_conv=4, param_dtype="float32",
    dtype="float32")
