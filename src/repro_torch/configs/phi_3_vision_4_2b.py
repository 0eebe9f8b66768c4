"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend STUB
[hf:microsoft/Phi-3-vision-128k-instruct]. The batch supplies precomputed
patch embeddings (prepended to the text tokens)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm", num_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32064,
    act="swiglu", n_vision_tokens=576)

SMOKE = ModelConfig(
    name="phi-3-vision-4.2b-smoke", family="vlm", num_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
    act="swiglu", n_vision_tokens=16, param_dtype="float32",
    dtype="float32")
