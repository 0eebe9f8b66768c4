"""h2o-danube-3-4b [dense] — llama+mistral mix with SWA [arXiv:2401.16818].
SWA window => sub-quadratic => long_500k runs with a rolling-window cache."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense", num_layers=24, d_model=3840,
    n_heads=32, n_kv_heads=8, d_ff=10240, vocab_size=32000,
    window=4096, act="swiglu")

SMOKE = ModelConfig(
    name="h2o-danube-3-4b-smoke", family="dense", num_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
    window=32, act="swiglu", param_dtype="float32", dtype="float32")
