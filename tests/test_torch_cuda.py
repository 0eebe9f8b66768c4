"""The port's CUDA kernels and its serving path on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (each
test decides in its fixture, never at import).  On a machine with the
card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernels are held against their plain versions on the same card inputs:
bf16 at 2e-2, fp32 at 2e-5 (TF32 off for the fp32 references), the
selective scan at 2e-4 in y and its last state (fp32 arithmetic for either
u dtype; a sum over up to S decayed terms in another order).  The SMOKE
models on the card are held against themselves on the CPU at 1e-4.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.kernels import ssm_scan as tss  # noqa: E402
from repro_torch.kernels import swiglu as tsg  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serve import (ServeEngine, decode_sequential,  # noqa: E402
                               scripted_trace)

pytestmark = pytest.mark.cuda
TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
       torch.float32: dict(rtol=2e-5, atol=2e-5)}
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


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


def _scan_inputs(dev, B, S, di, ds, u_dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    u = rnd(B, S, di).to(u_dtype)
    dt = torch.nn.functional.softplus(rnd(B, S, di) - 1.0)
    return u, dt, rnd(B, S, ds), rnd(B, S, ds), -torch.exp(rnd(di, ds) * 0.3)


@pytest.mark.parametrize("u_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,di,ds", [
    (1, 1, 8192, 16),          # one step
    (2, 37, 200, 16),          # ragged S and a partial block of channels
    (1, 1000, 512, 16),        # the prefill's S
    (3, 130, 64, 4),           # the SMOKE model's d_state
])
def test_ssm_scan_kernel(dev, u_dtype, B, S, di, ds):
    args = _scan_inputs(dev, B, S, di, ds, u_dtype)
    n = tss.launches
    y, h = tss.ssm_scan(*args)
    torch.cuda.synchronize()
    assert tss.launches == n + 1
    assert y.dtype == h.dtype == torch.float32
    want_y, want_h = ref.ssm_scan(*args)
    torch.testing.assert_close(y, want_y, **SCAN_TOL)
    torch.testing.assert_close(h, want_h, **SCAN_TOL)


def test_ssm_scan_kernel_reads_strided_inputs(dev):
    """u as one half of the fused in-projection, B and C as slices of the
    x-projection: the wrapper makes them contiguous."""
    u2, dt, _, _, A = _scan_inputs(dev, 2, 45, 2 * 96, 16, torch.bfloat16)
    dt = dt[..., :96]
    proj = torch.randn(2, 45, 40, device=dev)
    u, Bc, Cc = u2[..., :96], proj[..., 8:24], proj[..., 24:40]
    assert not (u.is_contiguous() or Bc.is_contiguous())
    y, h = tss.ssm_scan(u, dt, Bc, Cc, A[:96])
    want_y, want_h = ref.ssm_scan(u.contiguous(), dt.contiguous(),
                                  Bc.contiguous(), Cc.contiguous(),
                                  A[:96].contiguous())
    torch.testing.assert_close(y, want_y, **SCAN_TOL)
    torch.testing.assert_close(h, want_h, **SCAN_TOL)


def test_ssm_scan_kernel_rejects_what_it_does_not_take(dev):
    u, dt, Bc, Cc, A = _scan_inputs(dev, 1, 8, 32, 16, torch.float32)
    with pytest.raises(TypeError, match="dt must be float32"):
        tss.ssm_scan(u, dt.bfloat16(), Bc, Cc, A)
    big = torch.zeros(1, 8, 17, device=dev)
    with pytest.raises(ValueError, match="d_state 17"):
        tss.ssm_scan(u, dt, big, big, torch.zeros(32, 17, device=dev))


def _to(node, dev):
    return {k: _to(v, dev) for k, v in node.items()} \
        if isinstance(node, dict) else node.to(dev)


@pytest.mark.parametrize("arch", ["llama3-8b", "falcon-mamba-7b"])
def test_smoke_model_on_card_matches_cpu(dev, arch):
    b = registry.get_bundle(arch, smoke=True)
    cpu = b.init(b.cfg, seed=0, device="cpu")
    gpu = _to(cpu, dev)
    tokens = torch.randint(0, 256, (2, 21),
                           generator=torch.Generator().manual_seed(0))
    want, _ = b.forward(cpu, {"tokens": tokens}, b.cfg)
    got, _ = b.forward(gpu, {"tokens": tokens.to(dev)}, b.cfg)
    torch.testing.assert_close(got.cpu(), want, **MODEL_TOL)


def test_smoke_mamba_prefill_and_decode_on_card_match_cpu(dev):
    b = registry.get_bundle("falcon-mamba-7b", smoke=True)
    cpu = b.init(b.cfg, seed=0, device="cpu")
    gpu = _to(cpu, dev)
    tokens = torch.randint(0, 256, (2, 37),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for tag, p, d in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
        n = tss.launches
        last, cache = b.prefill(p, {"tokens": tokens.to(d)}, b.cfg, 48)
        assert tss.launches - n == (2 if tag == "gpu" else 0)
        res = [last]
        tok = torch.argmax(last, -1, keepdim=True)
        for _ in range(4):
            lg, cache = b.decode_step(p, tok, cache, b.cfg)
            res.append(lg)
            tok = torch.argmax(lg, -1, keepdim=True)
        out[tag] = res + [cache["ssm"]["h"], cache["ssm"]["conv"]]
    for want, got in zip(out["cpu"], out["gpu"]):
        torch.testing.assert_close(got.cpu(), want, **MODEL_TOL)


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


def test_mamba_engine_on_card_matches_sequential(dev):
    b = registry.get_bundle("falcon-mamba-7b", smoke=True)
    params = b.init(b.cfg, seed=0, device=dev)
    reqs = scripted_trace(8, vocab_size=256, seed=5, prompt_lens=(6, 12, 24),
                          gen_lens=(4, 8, 16))
    counts = (trn.launches, tss.launches, tsg.launches, tfa.launches)
    rep = ServeEngine(b, params, max_batch=3, max_len=40,
                      device=dev).run(reqs)
    steps = len(reqs) + rep.decode_steps
    assert trn.launches - counts[0] == 3 * steps
    assert tss.launches - counts[1] == 2 * len(reqs)
    assert (tsg.launches, tfa.launches) == counts[2:]
    want = decode_sequential(b, params, reqs, max_len=40, device=dev)
    assert {c.rid: c.tokens for c in rep.completions} == want
