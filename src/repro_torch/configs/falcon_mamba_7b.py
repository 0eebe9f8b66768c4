"""falcon-mamba-7b [ssm] — attention-free Mamba-1 [arXiv:2410.05355].
O(1) decode state => long_500k runs."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm", num_layers=64, d_model=4096,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2)

SMOKE = ModelConfig(
    name="falcon-mamba-7b-smoke", family="ssm", num_layers=2, d_model=64,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=256,
    ssm_state=4, ssm_conv=4, ssm_expand=2, dt_rank=8,
    param_dtype="float32", dtype="float32")
