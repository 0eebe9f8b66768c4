"""The port's CUDA kernels and its serving path on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (each
test decides in its fixture, never at import).  On a machine with the
card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernels are held against their plain versions on the same card inputs:
bf16 at 2e-2, fp32 at 2e-5 (TF32 off for the fp32 references).  The SMOKE
model on the card is held against itself on the CPU at 1e-4.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.kernels import swiglu as tsg  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serve import (ServeEngine, decode_sequential,  # noqa: E402
                               scripted_trace)

pytestmark = pytest.mark.cuda
TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
       torch.float32: dict(rtol=2e-5, atol=2e-5)}


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda", torch.cuda.current_device())


def _randn(dev, *shape, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,D", [(8, 4096), (37, 100), (300, 128)])
def test_rmsnorm_kernel(dev, dtype, rows, D):
    x, s = _randn(dev, rows, D, dtype=dtype), _randn(dev, D, dtype=dtype,
                                                     seed=1)
    n = trn.launches
    got = trn.rmsnorm(x, s, 1e-5)
    torch.cuda.synchronize()
    assert trn.launches == n + 1
    torch.testing.assert_close(got, ref.rmsnorm(x, s, 1e-5), **TOL[dtype])


@pytest.mark.parametrize("dti,dto", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("shape", [(8, 14336), (3, 5, 77)])
def test_swiglu_kernel(dev, dti, dto, shape):
    g, u = _randn(dev, *shape, dtype=dti), _randn(dev, *shape, dtype=dti,
                                                  seed=1)
    got = tsg.swiglu(g, u, dto)
    torch.testing.assert_close(got, ref.swiglu(g, u, dto), **TOL[dto])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,H,Hk,hd,kw", [
    (1, 128, 128, 4, 4, 64, {}),
    (2, 100, 100, 8, 2, 128, {}),
    (2, 40, 100, 4, 1, 32, {}),
    (1, 130, 90, 4, 2, 16, {}),                 # fully-masked rows
    (1, 257, 257, 4, 2, 64, {"window": 50}),
    (1, 200, 200, 4, 2, 64, {"softcap": 20.0}),
    (1, 77, 77, 4, 2, 64, {"causal": False}),
])
def test_flash_attention_kernel(dev, dtype, B, Sq, Sk, H, Hk, hd, kw):
    q = _randn(dev, B, Sq, H, hd, dtype=dtype)
    k = _randn(dev, B, Sk, Hk, hd, dtype=dtype, seed=1)
    v = _randn(dev, B, Sk, Hk, hd, dtype=dtype, seed=2)
    kw = {"causal": True, **kw}
    got = tfa.flash_attention(q, k, v, **kw)
    torch.testing.assert_close(got, ref.flash_attention(q, k, v, **kw),
                               **TOL[dtype])


def test_flash_attention_reads_strided_inputs(dev):
    """q/k/v as slices of one fused projection: no copies needed."""
    qkv = _randn(dev, 2, 50, 6, 64, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:5], qkv[:, :, 5:6]
    got = tfa.flash_attention(q, k, v)
    want = ref.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous())
    torch.testing.assert_close(got, want, **TOL[torch.bfloat16])


def test_smoke_model_on_card_matches_cpu(dev):
    b = registry.get_bundle("llama3-8b", smoke=True)
    cpu = b.init(b.cfg, seed=0, device="cpu")

    def to(node):
        return {k: to(v) for k, v in node.items()} if isinstance(node, dict) \
            else node.to(dev)

    gpu = to(cpu)
    tokens = torch.randint(0, 256, (2, 21),
                           generator=torch.Generator().manual_seed(0))
    want, _ = b.forward(cpu, {"tokens": tokens}, b.cfg)
    got, _ = b.forward(gpu, {"tokens": tokens.to(dev)}, b.cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_engine_on_card_matches_sequential(dev):
    b = registry.get_bundle("llama3-8b", smoke=True)
    params = b.init(b.cfg, seed=0, device=dev)
    reqs = scripted_trace(8, vocab_size=256, seed=5, prompt_lens=(6, 12, 24),
                          gen_lens=(4, 8, 16))
    counts = (trn.launches, tsg.launches, tfa.launches)
    rep = ServeEngine(b, params, max_batch=3, max_len=40,
                      device=dev).run(reqs)
    steps = len(reqs) + rep.decode_steps
    assert trn.launches - counts[0] == 5 * steps
    assert tsg.launches - counts[1] == 2 * steps
    assert tfa.launches - counts[2] == 2 * len(reqs)
    want = decode_sequential(b, params, reqs, max_len=40, device=dev)
    assert {c.rid: c.tokens for c in rep.completions} == want
