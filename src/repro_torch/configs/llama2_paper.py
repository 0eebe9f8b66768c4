"""Llama2 family exactly as in HETHUB Table 1 (paper experiments).

These drive the paper-reproduction benchmarks (Fig. 6-8) through the
predictor/simulator; llama2_7b also runs as a real config.  The port's
copy of ``repro/configs/llama2_paper.py``."""
from repro_torch.models.config import ModelConfig


def _llama2(name, layers, hidden, heads, kv_heads, ff, vocab=32000):
    return ModelConfig(
        name=name, family="dense", num_layers=layers, d_model=hidden,
        n_heads=heads, n_kv_heads=kv_heads, d_ff=ff, vocab_size=vocab,
        act="swiglu")


LLAMA2_7B = _llama2("llama2-7b", 32, 4096, 32, 32, 11008)
LLAMA2_13B = _llama2("llama2-13b", 40, 5120, 40, 40, 13824)
LLAMA2_35B = _llama2("llama2-35b", 40, 8192, 64, 8, 22016)
LLAMA2_70B = _llama2("llama2-70b", 80, 8192, 64, 8, 28672)
LLAMA2_140B = _llama2("llama2-140b", 160, 8192, 64, 8, 28672)

PAPER_MODELS = {
    "llama2-7b": LLAMA2_7B, "llama2-13b": LLAMA2_13B,
    "llama2-35b": LLAMA2_35B, "llama2-70b": LLAMA2_70B,
    "llama2-140b": LLAMA2_140B,
}
