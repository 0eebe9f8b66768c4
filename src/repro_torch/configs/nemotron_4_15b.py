"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense", num_layers=32, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=24576, vocab_size=256000,
    act="sq_relu")

SMOKE = ModelConfig(
    name="nemotron-4-15b-smoke", family="dense", num_layers=2, d_model=96,
    n_heads=4, n_kv_heads=2, d_ff=192, vocab_size=256,
    act="sq_relu", param_dtype="float32", dtype="float32")
