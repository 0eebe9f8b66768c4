"""PyTorch/CUDA port of the HETHUB reproduction (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its module
names and array layouts so each port module sits beside its counterpart:

  models/config.py       ModelConfig (torch dtypes)
  models/layers.py       rmsnorm, RoPE, attention, cached decode, MLP
  models/transformer.py  init_lm, lm_forward, lm_prefill, lm_decode_step
  models/registry.py     arch id -> ArchBundle
  models/convert.py      JAX parameter tree -> torch tensors
  kernels/               hand-written Hopper kernels + plain versions
  serve/                 continuous-batching ServeEngine
  launch/serve.py        serving CLI

Nothing here imports ``jax`` or ``repro``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; with no CUDA device they raise.
"""
