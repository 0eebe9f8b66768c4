"""The port's CUDA kernels and its serving path on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (each
test decides in its fixture, never at import).  On a machine with the
card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernels are held against their plain versions on the same card inputs:
bf16 at 2e-2, fp32 at 2e-5 (TF32 off for the fp32 references), the
selective scan at 2e-4 in y and its last state (fp32 arithmetic for either
u dtype; a sum over up to S decayed terms in another order).  bf16
attention runs on the tensor cores, which take P and dS as bf16 operands
(as SDPA does) where the plain versions keep them in fp32: its outputs,
forward and backward, are held at the bf16 tolerance and, since 2e-2 is
as large as a typical value there, each tensor also by its norm-relative
error ||got - want|| / ||want|| <= 1e-2 (bf16 rounding reads a few 1e-3,
one key tile or ring hop left out 1e-1 and more; ``chip_smoke.py`` reads
both on every run).  fp32 attention runs on the
FMA kernels; the ring hop backward sums dq over key tiles with fp32
atomics, whose order changes the last bits only, inside 2e-5.  The SMOKE
models, three SMOKE train steps on each route, and the SMOKE pipeline
loss and its gradients on the card are held against the CPU at 1e-4.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ring_attention as tra  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.kernels import ssm_scan as tss  # noqa: E402
from repro_torch.kernels import swiglu as tsg  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serve import (ServeEngine, decode_sequential,  # noqa: E402
                               scripted_trace)

pytestmark = pytest.mark.cuda
TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
       torch.float32: dict(rtol=2e-5, atol=2e-5)}
BF16_REL = 1e-2
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
# the scan's VJP by each gradient's norm, as chip_smoke.py holds it: fp32
# sums over up to S decayed terms in another order; du in bf16 may round
# one bf16 step apart where the two sums straddle a rounding boundary
SCAN_BWD_REL = 1e-4
SCAN_BWD_BF16_DU_REL = 2e-4
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


def _rel(got, want) -> float:
    """||got - want|| / ||want||."""
    g, w = got.double(), want.double()
    return ((g - w).norm() / w.norm()).item()


def _close_attention(got, want, dtype):
    """Attention outputs at ``dtype``'s tolerance; bf16 (the tensor cores)
    also within BF16_REL of ``want``'s norm."""
    torch.testing.assert_close(got, want, **TOL[dtype])
    if dtype == torch.bfloat16:
        rel = _rel(got, want)
        assert rel <= BF16_REL, rel


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,D", [
    (8, 4096), (37, 100), (300, 128),
    # decode-sized row counts at llama's and a 5120 width (4 packs a thread)
    (1, 4096), (3, 4096), (64, 4096), (1, 5120), (3, 5120), (8, 5120),
    (64, 5120),
    (5, 37),                     # one element a pack
    (3, 16384), (2, 20480),      # the last register layout; the loop kernel
])
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
    _close_attention(got, ref.flash_attention(q, k, v, **kw), dtype)


@pytest.mark.parametrize("B,Sq,Sk,H,Hk,hd,kw", [
    (1, 257, 257, 4, 2, 16, {}),                # every head dim, ragged S
    (2, 257, 257, 4, 2, 32, {}),
    (1, 257, 257, 4, 2, 64, {}),
    (1, 257, 257, 4, 2, 128, {}),
    (1, 1000, 1000, 8, 2, 128, {}),             # the prefill's length
    (1, 100, 1000, 8, 2, 128, {}),              # Sq < Sk
    (1, 300, 200, 8, 2, 64, {}),                # Sq > Sk: masked rows
    (1, 1000, 1000, 4, 1, 128, {"window": 256}),
    (1, 1000, 1000, 4, 2, 128, {"softcap": 50.0}),
    (2, 200, 200, 8, 1, 64, {}),                # MQA
    (1, 130, 130, 4, 2, 32, {"causal": False}),
])
def test_flash_attention_tensor_cores(dev, B, Sq, Sk, H, Hk, hd, kw):
    """The bf16 forward on the tensor cores, and its lse, against the
    plain version; rows that see no key are exactly 0 with lse +inf."""
    bf = torch.bfloat16
    q = _randn(dev, B, Sq, H, hd, dtype=bf)
    k = _randn(dev, B, Sk, Hk, hd, dtype=bf, seed=1)
    v = _randn(dev, B, Sk, Hk, hd, dtype=bf, seed=2)
    kw = {"causal": True, **kw}
    n = tfa.launches
    got, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert tfa.launches == n + 1
    want, want_lse = ref.flash_attention(q, k, v, return_lse=True, **kw)
    _close_attention(got, want, bf)
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])
    if Sq > Sk and kw["causal"]:
        assert got[:, :Sq - Sk].abs().max().item() == 0.0
        assert torch.isinf(lse[:, :Sq - Sk]).all()


def test_flash_attention_refuses_unaligned_bf16(dev):
    """The tensor-core kernel copies 16 bytes at a time: a bf16 view whose
    rows are not 16-byte aligned is refused, not read wrongly."""
    x = _randn(dev, 1, 8, 3, 36, dtype=torch.bfloat16)
    q = x[..., :32]                      # head stride 36 elements: 72 B
    assert q.stride(2) * 2 % 16 != 0
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention(q, q, q)


def test_flash_attention_reads_strided_inputs(dev):
    """q/k/v as slices of one fused projection: no copies needed."""
    qkv = _randn(dev, 2, 50, 6, 64, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:5], qkv[:, :, 5:6]
    got = tfa.flash_attention(q, k, v)
    want = ref.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous())
    _close_attention(got, want, torch.bfloat16)


@pytest.mark.parametrize("hd", [24, 40, 96, 120, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,H,Hk,kw", [
    (1, 257, 257, 4, 2, {}),                    # GQA, ragged S
    (2, 100, 300, 8, 1, {"window": 64}),        # MQA, Sq < Sk, window
    (1, 300, 200, 4, 2, {}),                    # Sq > Sk: masked rows
    (1, 333, 333, 4, 2, {"window": 100, "softcap": 30.0}),
    (1, 77, 77, 4, 4, {"causal": False}),
])
def test_flash_attention_any_head_dim(dev, hd, dtype, B, Sq, Sk, H, Hk, kw):
    """Head dims that are multiples of 8 but not tile widths (24, 40,
    phi-3-vision-4.2b's 96, h2o-danube-3-4b's 120) run in the next tile, their extra columns
    zero-filled; 128 is the tile itself.  Forward and lse against the
    plain version, and q/k/v read as strided slices of one projection."""
    qkv = _randn(dev, B, max(Sq, Sk), H + 2 * Hk, hd, dtype=dtype)
    q = qkv[:, :Sq, :H]
    k, v = qkv[:, :Sk, H:H + Hk], qkv[:, :Sk, H + Hk:]
    kw = {"causal": True, **kw}
    n = tfa.launches
    got, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert tfa.launches == n + 1
    assert got.shape == (B, Sq, H, hd) and got.is_contiguous()
    want, want_lse = ref.flash_attention(q.contiguous(), k.contiguous(),
                                         v.contiguous(), return_lse=True,
                                         **kw)
    _close_attention(got, want, dtype)
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])
    if Sq > Sk and kw["causal"]:
        assert got[:, :Sq - Sk].abs().max().item() == 0.0


def test_flash_attention_refuses_other_head_dims(dev):
    x = _randn(dev, 1, 8, 2, 264, dtype=torch.bfloat16)
    for t in (x[..., :20], x):        # not a multiple of 8; past 256
        with pytest.raises(ValueError, match="multiples of 8"):
            tfa.flash_attention(t, t, t)


# recurrentgemma-9b's attention: head dim 256 over one KV head (MQA),
# window 2048; 136 and 192 run in the 256 tile
HD256_CASES = [
    (1, 1000, 1000, 16, 1, 256, {"window": 300}),
    (1, 257, 257, 4, 2, 256, {}),               # GQA, ragged S
    (2, 100, 300, 8, 1, 256, {"window": 64}),   # Sq < Sk, the band
    (1, 300, 200, 4, 1, 256, {}),               # Sq > Sk: masked rows
    (1, 333, 333, 4, 1, 192, {"window": 100, "softcap": 30.0}),
    (1, 130, 130, 4, 1, 136, {"causal": False}),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,H,Hk,hd,kw", HD256_CASES)
def test_flash_attention_head_dim_256_on_card(dev, dtype, B, Sq, Sk, H, Hk,
                                              hd, kw):
    """The forward in the 256 tile (bf16: Q's fragments read from shared
    memory a k-step, 32-key tiles; fp32: the FMA kernel), with and
    without lse, against the plain version; masked rows exactly 0."""
    q = _randn(dev, B, Sq, H, hd, dtype=dtype)
    k = _randn(dev, B, Sk, Hk, hd, dtype=dtype, seed=1)
    v = _randn(dev, B, Sk, Hk, hd, dtype=dtype, seed=2)
    kw = {"causal": True, **kw}
    n = tfa.launches
    plain = tfa.flash_attention(q, k, v, **kw)
    got, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert tfa.launches == n + 2
    want, want_lse = ref.flash_attention(q, k, v, return_lse=True, **kw)
    _close_attention(got, want, dtype)
    assert torch.equal(plain, got)
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])
    if Sq > Sk and kw["causal"]:
        assert got[:, :Sq - Sk].abs().max().item() == 0.0
        assert torch.isinf(lse[:, :Sq - Sk]).all()


@pytest.mark.parametrize("B,Sq,Sk,H,Hk,hd,kw", HD256_CASES)
def test_flash_backward_head_dim_256_on_card(dev, B, Sq, Sk, H, Hk, hd, kw):
    """The bf16 flash backward in the 256 tile (two warps a strip of 16
    keys, each with half of dK's and dV's columns) against autograd
    through the plain flash."""
    bf = torch.bfloat16
    q = _randn(dev, B, Sq, H, hd, dtype=bf).requires_grad_()
    k = _randn(dev, B, Sk, Hk, hd, dtype=bf, seed=1).requires_grad_()
    v = _randn(dev, B, Sk, Hk, hd, dtype=bf, seed=2).requires_grad_()
    do = _randn(dev, B, Sq, H, hd, dtype=bf, seed=3)
    kw = {"causal": True, **kw}
    n = tra.bwd_launches
    got = torch.autograd.grad(ops.flash_attention(q, k, v, **kw), (q, k, v),
                              do)
    assert tra.bwd_launches == n + 1
    want = torch.autograd.grad(ref.flash_attention(q, k, v, **kw),
                               (q, k, v), do)
    for g, w in zip(got, want):
        _close_attention(g, w, bf)


def test_flash_backward_fp32_refuses_head_dim_256(dev):
    """The fp32 backward's tiles stop at 128: hd 256 raises, naming it."""
    q = _randn(dev, 1, 16, 2, 256, dtype=torch.float32)
    z = torch.zeros(1, 1, 16, 2, 256, device=dev)
    lse = torch.zeros(1, 1, 16, 2, device=dev)
    with pytest.raises(ValueError, match="head dim 256"):
        tra.ring_step_bwd(q[None], q[None], q[None], q[None], lse, lse, z,
                          z.clone(), z.clone(), [(0, 0, 0, 16, 16)])


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


@pytest.mark.parametrize("u_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,di,ds,dt_kind", [
    (1, 63, 256, 16, "softplus"),     # one partial chunk of 64 steps
    (1, 64, 256, 16, "softplus"),     # one whole chunk
    (1, 65, 256, 16, "softplus"),     # a chunk and one step
    (3, 129, 101, 16, "softplus"),    # B 3; di not a multiple of 32
    (1, 4096, 512, 16, "softplus"),   # the training route's length
    (2, 70, 96, 1, "softplus"),       # d_state 1, 4, 15: the masked states
    (2, 70, 96, 4, "softplus"),
    (2, 70, 96, 15, "softplus"),
    (1, 4096, 256, 16, "near0"),      # decay ~1 for every step
    (1, 1000, 256, 16, "large"),      # |dt A| >= 50 on half the channels
])
def test_ssm_scan_kernel_edges(dev, u_dtype, B, S, di, ds, dt_kind):
    """Chunk edges, partial channel blocks, d_state below 16 (the plain-
    load path), B 3, long S, and decays from 1 (dt near 0, A near 0) to
    underflow (|dt A| >= 50): y and the last state at the scan's
    tolerance, one launch a call."""
    u, dt, Bc, Cc, A = _scan_inputs(dev, B, S, di, ds, u_dtype)
    if dt_kind == "near0":
        dt, A = dt * 1e-3, A * 1e-2
    elif dt_kind == "large":
        g = torch.Generator(device=dev).manual_seed(5)
        big = 50 + 50 * torch.rand((B, S, di), generator=g, device=dev)
        dt = torch.where(torch.arange(di, device=dev) % 2 == 0, big, dt)
        A = -(1 + torch.rand((di, ds), generator=g, device=dev))
    n = tss.launches
    y, h = tss.ssm_scan(u, dt, Bc, Cc, A)
    torch.cuda.synchronize()
    assert tss.launches == n + 1
    want_y, want_h = ref.ssm_scan(u, dt, Bc, Cc, A)
    torch.testing.assert_close(y, want_y, **SCAN_TOL)
    torch.testing.assert_close(h, want_h, **SCAN_TOL)


@pytest.mark.parametrize("u_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,di,ds", [
    (1, 37, 64, 16),       # S inside one chunk of 64 steps
    (2, 200, 96, 16),      # B 2; S over 4 chunks, the last ragged
    (1, 129, 40, 4),       # d_state 4; a partial block of channels
    (2, 70, 300, 1),       # d_state 1; channels over two clusters
    (1, 520, 256, 16),     # 9 chunks of one whole cluster of channels
])
def test_ssm_scan_bwd_kernel(dev, u_dtype, B, S, di, ds):
    """The VJP kernel (split over time: chunks chained by their carries)
    against the plain reverse loop, each gradient by its norm; one count
    a call, and a second call equal bit for bit (no float atomics).  The
    forward with its chunk states gives y and h of the forward without."""
    args = _scan_inputs(dev, B, S, di, ds, u_dtype)
    dy = _randn(dev, B, S, di, dtype=torch.float32, seed=3)
    y0, h0 = tss.ssm_scan(*args)
    y, h, hc = tss.ssm_scan(*args, keep_chunks=True)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    n = tss.bwd_launches
    got = tss.ssm_scan_bwd(*args, hc, dy)
    again = tss.ssm_scan_bwd(*args, hc, dy)
    torch.cuda.synchronize()
    assert tss.bwd_launches == n + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert got[0].dtype == u_dtype
    assert all(g.dtype == torch.float32 for g in got[1:])
    want = ref.ssm_scan_bwd(*args, dy)
    for name, g, w in zip(("du", "ddt", "dB", "dC", "dA"), got, want):
        limit = SCAN_BWD_BF16_DU_REL if name == "du" and \
            u_dtype == torch.bfloat16 else SCAN_BWD_REL
        assert _rel(g, w) <= limit, (name, _rel(g, w))


def _to(node, dev):
    if isinstance(node, dict):
        return {k: _to(v, dev) for k, v in node.items()}
    if isinstance(node, list):      # the hybrid stack's tail
        return [_to(v, dev) for v in node]
    return node.to(dev)


@pytest.mark.parametrize("arch", ["llama3-8b", "falcon-mamba-7b",
                                  "qwen3-14b", "nemotron-4-15b",
                                  "h2o-danube-3-4b"])
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


def test_smoke_griffin_on_card_matches_cpu(dev):
    """recurrentgemma-9b SMOKE at 5 layers (a group and a tail of two rec
    blocks), fp32: forward, the prefill of 40 tokens (past the window of
    32), its cache and 4 decode steps on the card against the CPU."""
    b = registry.get_bundle("recurrentgemma-9b", smoke=True, num_layers=5)
    cpu = b.init(b.cfg, seed=0, device="cpu")
    gpu = _to(cpu, dev)
    tokens = torch.randint(0, 256, (2, 40),
                           generator=torch.Generator().manual_seed(2))
    want, _ = b.forward(cpu, {"tokens": tokens}, b.cfg)
    got, _ = b.forward(gpu, {"tokens": tokens.to(dev)}, b.cfg)
    torch.testing.assert_close(got.cpu(), want, **MODEL_TOL)
    out = {}
    for tag, p, d in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
        last, cache = b.prefill(p, {"tokens": tokens.to(d)}, b.cfg, 64)
        res = [last]
        tok = torch.argmax(last, -1, keepdim=True)
        for _ in range(4):
            lg, cache = b.decode_step(p, tok, cache, b.cfg)
            res.append(lg)
            tok = torch.argmax(lg, -1, keepdim=True)
        out[tag] = res + [cache["rec"]["h"], cache["rec"]["conv"],
                          cache["kv"]["k"], cache["kv"]["v"]]
    for want, got in zip(out["cpu"], out["gpu"]):
        torch.testing.assert_close(got.cpu(), want, **MODEL_TOL)


def test_griffin_bf16_prefill_and_decode_on_card(dev):
    """A 5-layer bf16 Griffin at recurrentgemma-9b's attention shape (head
    dim 256, one KV head, window 32 here): the prefill of 70 tokens and 4
    decode steps across the wrapped buffer against ``lm_forward`` of the
    same tokens, by the logits' norm (bf16: 2e-2), with exact launches
    (two norms a block and the final one; flash once an attn layer in the
    prefill, never in a decode step)."""
    b = registry.get_bundle(
        "recurrentgemma-9b", smoke=True, num_layers=5, d_model=512,
        n_heads=2, lru_width=512, d_ff=1024, param_dtype="bfloat16",
        dtype="bfloat16")
    assert b.cfg.hd == 256 and b.cfg.n_kv_heads == 1
    params = b.init(b.cfg, seed=0, device=dev)
    tokens = torch.randint(0, 256, (1, 74), device=dev,
                           generator=torch.Generator(dev).manual_seed(3))
    full, _ = b.forward(params, {"tokens": tokens}, b.cfg)
    ops.reset_launch_counts()
    last, cache = b.prefill(params, {"tokens": tokens[:, :70]}, b.cfg, 96)
    got = [last]
    for i in range(4):
        lg, cache = b.decode_step(params, tokens[:, 70 + i:71 + i], cache,
                                  b.cfg)
        got.append(lg)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["rmsnorm"] == 5 * (2 * 5 + 1)
    for i, g in enumerate(got):
        assert torch.isfinite(g).all()
        assert _rel(g.float(), full[:, 69 + i].float()) <= 2e-2


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


# launches a prefill or decode step makes: (rmsnorm, swiglu, flash) a layer
# and the final norm's one rmsnorm; flash in prefills only
DENSE_LAUNCHES = {"qwen3-14b": (4, 1, 1), "nemotron-4-15b": (2, 0, 1),
                  "h2o-danube-3-4b": (2, 1, 1)}


@pytest.mark.parametrize("arch", sorted(DENSE_LAUNCHES))
def test_smoke_dense_prefill_and_decode_on_card_match_cpu(dev, arch):
    """The new dense archs' prefill, cache and 4 decode steps (per-row
    positions) on the card against the CPU at 1e-4, with each kernel's
    launches: qk_norm's two rmsnorms a layer, nemotron's MLP in plain
    torch, danube's prompt of 37 past its window of 32 in a rolling
    buffer of 32 at max_len 48."""
    b = registry.get_bundle(arch, smoke=True)
    cpu = b.init(b.cfg, seed=0, device="cpu")
    gpu = _to(cpu, dev)
    L = b.cfg.num_layers
    rn, sg, fl = DENSE_LAUNCHES[arch]
    tokens = torch.randint(0, 256, (2, 37),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for tag, p, d in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
        n = (trn.launches, tsg.launches, tfa.launches)
        last, cache = b.prefill(p, {"tokens": tokens.to(d)}, b.cfg, 48)
        cache["pos"] = torch.tensor([37, 35], device=d)
        res = [last]
        tok = torch.argmax(last, -1, keepdim=True)
        for _ in range(4):
            lg, cache = b.decode_step(p, tok, cache, b.cfg)
            res.append(lg)
            tok = torch.argmax(lg, -1, keepdim=True)
        got_n = (trn.launches - n[0], tsg.launches - n[1],
                 tfa.launches - n[2])
        want_n = ((rn * L + 1) * 5, sg * L * 5, fl * L) if tag == "gpu" \
            else (0, 0, 0)
        assert got_n == want_n, (tag, got_n, want_n)
        out[tag] = res + [cache["kv"]["k"], cache["kv"]["v"]]
    assert out["gpu"][-1].shape[2] == min(48, b.cfg.window or 48)
    for want, got in zip(out["cpu"], out["gpu"]):
        torch.testing.assert_close(got.cpu(), want, **MODEL_TOL)


def test_swa_engine_on_card_matches_sequential(dev):
    """danube SMOKE at max_len 48: prompts and streams past the window of
    32, so every row's buffer wraps; the engine equals each request alone
    on the card, with its launch counts."""
    b = registry.get_bundle("h2o-danube-3-4b", smoke=True)
    params = b.init(b.cfg, seed=0, device=dev)
    reqs = scripted_trace(8, vocab_size=256, seed=5,
                          prompt_lens=(20, 30, 36), gen_lens=(6, 12))
    counts = (trn.launches, tsg.launches, tfa.launches)
    rep = ServeEngine(b, params, max_batch=3, max_len=48,
                      device=dev).run(reqs)
    steps = len(reqs) + rep.decode_steps
    assert trn.launches - counts[0] == 5 * steps
    assert tsg.launches - counts[1] == 2 * steps
    assert tfa.launches - counts[2] == 2 * len(reqs)
    want = decode_sequential(b, params, reqs, max_len=48, device=dev)
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


# ------------------------------------------------------ training path ----
def _carry(dev, R, B, C, H, hd):
    return (torch.full((R, B, C, H, 1), ref.NEG_INF, device=dev),
            torch.zeros((R, B, C, H, 1), device=dev),
            torch.zeros((R, B, C, H, hd), device=dev))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hop", [(0, 0, 0, 100, 100), (100, 0, 0, 100, 100),
                                 (0, 0, 100, 100, 100),
                                 (130, 0, 60, 37, 100)])
def test_ring_step_kernel_one_hop(dev, dtype, hop):
    """Self, past, wrap (fully masked) and ragged partial hops over a warm
    carry, one rank: bf16 (the tensor cores) at the bf16 tolerance and
    norm, fp32 at the fp32 tolerance."""
    q = _randn(dev, 1, 2, 100, 8, 64, dtype=dtype)
    k = _randn(dev, 1, 2, 100, 2, 64, dtype=dtype, seed=1)
    v = _randn(dev, 1, 2, 100, 2, 64, dtype=dtype, seed=2)
    warm = ref.ring_step(q, k, v, *_carry(dev, 1, 2, 100, 8, 64),
                         [(hop[0], 0, hop[0], 100, 100)])
    n = tra.launches
    got = tra.ring_step(q, k, v, *warm, [hop])
    torch.cuda.synchronize()
    assert tra.launches == n + 1
    for g, w in zip(got, ref.ring_step(q, k, v, *warm, [hop])):
        _close_attention(g, w, dtype)
    if hop[2] > hop[0]:   # every key in the future: the carry passes
        for g, w in zip(got, warm):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_kernels_over_a_ragged_ring(dev, dtype):
    """Every step of a cp = 3 ring (chunks 70/51/33), forward carry and the
    accumulated backward, against the plain folds."""
    chunks = (70, 51, 33)
    q = _randn(dev, 3, 2, 70, 4, 32, dtype=dtype)
    k = _randn(dev, 3, 2, 70, 2, 32, dtype=dtype, seed=1)
    v = _randn(dev, 3, 2, 70, 2, 32, dtype=dtype, seed=2)
    carry = _carry(dev, 3, 2, 70, 4, 32)
    for s in range(3):
        hops = tra.ring_hops(chunks, s)
        got = tra.ring_step(q, k, v, *carry, hops)
        carry = ref.ring_step(q, k, v, *carry, hops)
        for g, w in zip(got, carry):
            _close_attention(g, w, dtype)
    # the pad rows past each chunk see no key (l = 0): o and lse as
    # kernels/ops.py makes them, 0 and +inf there
    m, l, acc = carry
    o = (acc / l.clamp_min(1e-30)).to(dtype)
    lse = torch.where(l > 0, m + torch.log(l), torch.inf)[..., 0]
    lse = lse.contiguous()
    do = _randn(dev, 3, 2, 70, 4, 32, dtype=dtype, seed=3)
    delta = (do.float() * o.float()).sum(-1)
    acc_k = [torch.zeros(t.shape, device=dev) for t in (q, k, v)]
    acc_r = [torch.zeros(t.shape, device=dev) for t in (q, k, v)]
    n = tra.bwd_launches
    for s in range(3):
        hops = tra.ring_hops(chunks, s)
        tra.ring_step_bwd(q, k, v, do, lse, delta, *acc_k, hops)
        ref.ring_step_bwd(q, k, v, do, lse, delta, *acc_r, hops)
    torch.cuda.synchronize()
    assert tra.bwd_launches == n + 3
    for g, w in zip(acc_k, acc_r):
        _close_attention(g, w, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_backward_skips_pad_rows(dev, dtype):
    """A ragged cp = 4 ring whose hops carry each rank's real q count
    (q_valid < Cq on three ranks): the forward leaves the pad rows' empty
    carry as it was, and with the pad rows' dout 0 (as ``unpad_chunks``
    gives) the real rows' gradients equal those of the same hops with
    q_valid = Cq within fp32 rounding (dq's atomics), while dq is exactly
    0 on the pad rows."""
    chunks = (130, 97, 72, 57)
    R, B, C, H, Hk, hd = 4, 1, 130, 8, 2, 128
    q = _randn(dev, R, B, C, H, hd, dtype=dtype)
    k = _randn(dev, R, B, C, Hk, hd, dtype=dtype, seed=1)
    v = _randn(dev, R, B, C, Hk, hd, dtype=dtype, seed=2)
    tables = [tra.ring_hops(chunks, s) for s in range(R)]
    assert all(h[4] == chunks[r] for t in tables for r, h in enumerate(t))
    full = [[h[:4] + (C,) for h in t] for t in tables]
    carry = _carry(dev, R, B, C, H, hd)
    for t in tables:
        carry = tra.ring_step(q, k, v, *carry, t)
    m, l, acc = carry
    for r, c in enumerate(chunks):
        assert (m[r, :, c:] == ref.NEG_INF).all()
        assert not l[r, :, c:].any() and not acc[r, :, c:].any()
    o = (acc / l.clamp_min(1e-30)).to(dtype)
    lse = torch.where(l > 0, m + torch.log(l), torch.inf)[..., 0]
    lse = lse.contiguous()
    do = _randn(dev, R, B, C, H, hd, dtype=dtype, seed=3)
    for r, c in enumerate(chunks):
        do[r, :, c:] = 0
    delta = (do.float() * o.float()).sum(-1)
    grads = {}
    for name, tabs in (("q_valid", tables), ("full", full)):
        acc3 = [torch.zeros(t.shape, device=dev) for t in (q, k, v)]
        for t in tabs:
            tra.ring_step_bwd(q, k, v, do, lse, delta, *acc3, t)
        grads[name] = acc3
    for g, w in zip(grads["q_valid"], grads["full"]):
        for r, c in enumerate(chunks):
            torch.testing.assert_close(g[r, :, :c], w[r, :, :c],
                                       **TOL[torch.float32])
    dq = grads["q_valid"][0]
    for r, c in enumerate(chunks[1:], 1):
        assert dq[r, :, c:].abs().max().item() == 0.0


@pytest.mark.parametrize("hd,H,Hk", [(16, 8, 2), (32, 8, 2), (64, 8, 2),
                                     (128, 8, 2), (64, 4, 1)])
@pytest.mark.parametrize("hop", [
    (0, 0, 0, 200, 200),       # the diagonal
    (330, 0, 260, 77, 200),    # offset +70, ragged k_valid
    (100, 0, 130, 200, 150),   # offset -30: rows < 30 see no key; pad rows
    (400, 0, 0, 131, 97),      # all past: no edge but k_valid and q_valid
    (0, 0, 500, 200, 200),     # all future: fully masked
])
def test_ring_step_tensor_cores(dev, hd, H, Hk, hop):
    """The bf16 hop on the tensor cores over a warm carry, GQA 4 and MQA,
    every head dim: the carry at the bf16 tolerance and norm; rows that
    see no key (pad rows past q_valid, rows before the keys, a fully
    masked hop) keep it bit for bit."""
    bf, C, B = torch.bfloat16, 200, 2
    q = _randn(dev, 1, B, C, H, hd, dtype=bf)
    k = _randn(dev, 1, B, C, Hk, hd, dtype=bf, seed=1)
    v = _randn(dev, 1, B, C, Hk, hd, dtype=bf, seed=2)
    warm = ref.ring_step(q, k, v, *_carry(dev, 1, B, C, H, hd),
                         [(hop[0], 0, hop[0] - 1000, C, C)])
    n = tra.launches
    got = tra.ring_step(q, k, v, *warm, [hop])
    torch.cuda.synchronize()
    assert tra.launches == n + 1
    want = ref.ring_step(q, k, v, *warm, [hop])
    for g, w in zip(got, want):
        _close_attention(g, w, bf)
    seen = ref.hop_mask([hop], C, C, causal=True, device=dev)[0].any(-1)
    for g, w in zip(got, warm):
        assert torch.equal(g[:, :, ~seen], w[:, :, ~seen])


def test_ring_step_tensor_cores_norm_check_can_fail(dev):
    """The norm-relative check reads a sound kernel well inside BF16_REL
    and the plain fold with one key tile (keys 64-127) left out well
    above it."""
    bf, C, H, Hk, hd = torch.bfloat16, 256, 8, 2, 128
    q = _randn(dev, 1, 1, C, H, hd, dtype=bf)
    k = _randn(dev, 1, 1, C, Hk, hd, dtype=bf, seed=1)
    v = _randn(dev, 1, 1, C, Hk, hd, dtype=bf, seed=2)
    empty = _carry(dev, 1, 1, C, H, hd)
    hop = [(0, 0, 0, C, C)]
    got = tra.ring_step(q, k, v, *empty, hop)
    want = ref.ring_step(q, k, v, *empty, hop)
    ctl = empty
    for a, b in ((0, 64), (128, C)):
        ctl = ref.ring_step(q, k[:, :, a:b], v[:, :, a:b], *ctl,
                            [(0, 0, a, b - a, C)])
    assert _rel(got[2], want[2]) <= BF16_REL / 10
    assert _rel(ctl[2], want[2]) > BF16_REL


@pytest.mark.parametrize("hd", [32, 128])
def test_ring_step_tensor_cores_over_a_padded_ring(dev, hd):
    """Every step of a cp = 4 ring with ragged chunks (pad q tiles, ragged
    k_valid, past, diagonal and wrap hops): each step from the plain
    carry, at the bf16 tolerance and norm; the pad rows keep the empty
    carry bit for bit."""
    bf, chunks = torch.bfloat16, (261, 140, 197, 75)
    R, B, C, H, Hk = 4, 1, 261, 8, 2
    q = _randn(dev, R, B, C, H, hd, dtype=bf)
    k = _randn(dev, R, B, C, Hk, hd, dtype=bf, seed=1)
    v = _randn(dev, R, B, C, Hk, hd, dtype=bf, seed=2)
    carry = _carry(dev, R, B, C, H, hd)
    for s in range(R):
        hops = tra.ring_hops(chunks, s)
        got = tra.ring_step(q, k, v, *carry, hops)
        carry = ref.ring_step(q, k, v, *carry, hops)
        for g, w in zip(got, carry):
            _close_attention(g, w, bf)
        for r, c in enumerate(chunks):
            for g, w in zip(got, _carry(dev, R, B, C, H, hd)):
                assert torch.equal(g[r, :, c:], w[r, :, c:])


def test_ring_step_bwd_refuses_repeated_sources(dev):
    q = torch.zeros(2, 1, 8, 2, 16, device=dev)
    lse = torch.zeros(2, 1, 8, 2, device=dev)
    acc = [torch.zeros(q.shape, device=dev) for _ in range(3)]
    with pytest.raises(ValueError, match="repeat"):
        tra.ring_step_bwd(q, q, q, q, lse, lse, *acc,
                          [(0, 0, 0, 8, 8), (8, 0, 0, 8, 8)])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,D", [
    (8, 4096), (37, 100), (300, 128), (600, 256),
    # row counts about the grid of 2 blocks an SM (264 on 132 SMs), and
    # the training shape and one more
    (1, 4096), (263, 4096), (265, 4096), (4096, 4096), (4097, 4096),
    # widths: the qk-norm width, 4 and 8 packs a thread, the last ring
    # width in bf16, and past the ring (the general kernel)
    (64, 128), (300, 5120), (130, 8192), (50, 16384), (40, 20480),
])
def test_rmsnorm_bwd_kernel(dev, dtype, rows, D):
    x = _randn(dev, rows, D, dtype=dtype)
    s = _randn(dev, D, dtype=dtype, seed=1)
    dy = _randn(dev, rows, D, dtype=dtype, seed=2)
    n = trn.bwd_launches
    dx, ds = trn.rmsnorm_bwd(x, s, dy, 1e-5)
    torch.cuda.synchronize()
    assert trn.bwd_launches == n + 1
    _close_rmsnorm_bwd((dx, ds), (x, s, dy), dtype)


def _bwd_inputs(dev, rows, D, dtype, seed=0):
    return (_randn(dev, rows, D, dtype=dtype, seed=seed),
            _randn(dev, D, dtype=dtype, seed=seed + 1),
            _randn(dev, rows, D, dtype=dtype, seed=seed + 2))


def _close_rmsnorm_bwd(got, args, dtype):
    """dx against the plain backward at ``dtype``'s tolerance; dscale, an
    fp32 sum over the rows, at 2e-5 against the plain backward run in fp64
    (at 4096 rows two fp32 sums in different orders differ by more than
    2e-5: PERF.md)."""
    want_dx, _ = ref.rmsnorm_bwd(*args, 1e-5)
    _, want_ds = ref.rmsnorm_bwd(*(t.double() for t in args), 1e-5)
    torch.testing.assert_close(got[0], want_dx, **TOL[dtype])
    torch.testing.assert_close(got[1].double(), want_ds,
                               **TOL[torch.float32])


@pytest.mark.parametrize("rows,D,dtype", [
    (4096, 4096, torch.bfloat16),      # the ring kernel
    (37, 100, torch.float32),          # the general kernel
])
def test_rmsnorm_bwd_is_deterministic(dev, rows, D, dtype):
    """dscale's cross-block sum runs in a fixed order: two calls agree bit
    for bit.  A call of another size between them (another grid) leaves the
    barrier counter ready: the calls after it are still right."""
    args = _bwd_inputs(dev, rows, D, dtype)
    first = trn.rmsnorm_bwd(*args)
    other = _bwd_inputs(dev, 265, 5120, dtype, seed=5)
    dx_o, ds_o = trn.rmsnorm_bwd(*other)
    second = trn.rmsnorm_bwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])
    _close_rmsnorm_bwd((dx_o, ds_o), other, dtype)
    _close_rmsnorm_bwd(second, args, dtype)


def test_rmsnorm_bwd_is_one_kernel(dev):
    """dx and dscale come from one kernel a call, and nothing else runs on
    the card (the outputs and scratch are allocated, not filled)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = _bwd_inputs(dev, 4096, 4096, torch.bfloat16)
    trn.rmsnorm_bwd(*args)           # the stream's barrier counter, once
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            trn.rmsnorm_bwd(*args)
        torch.cuda.synchronize()
    seen = {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}
    assert list(seen.values()) == [3], seen
    assert "rmsnorm_bwd_ring_kernel" in next(iter(seen)), seen


@pytest.mark.parametrize("dti,dto", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("shape", [(8, 14336), (3, 5, 77)])
def test_swiglu_bwd_kernel(dev, dti, dto, shape):
    g = _randn(dev, *shape, dtype=dti)
    u = _randn(dev, *shape, dtype=dti, seed=1)
    dh = _randn(dev, *shape, dtype=dto, seed=2)
    for got, want in zip(tsg.swiglu_bwd(g, u, dh), ref.swiglu_bwd(g, u, dh)):
        torch.testing.assert_close(got, want, **TOL[dti])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,H,Hk,hd,causal", [
    (1, 128, 128, 4, 4, 64, True),
    (2, 100, 100, 8, 2, 128, True),
    (2, 40, 100, 4, 1, 32, True),        # queries at the end of the keys
    (1, 77, 77, 4, 2, 64, False),
])
def test_flash_backward_on_card(dev, dtype, B, Sq, Sk, H, Hk, hd, causal):
    """FlashAttentionFn (kernel forward with lse, one-rank hop backward)
    against autograd through the plain flash; the lse against the plain
    one."""
    q = _randn(dev, B, Sq, H, hd, dtype=dtype).requires_grad_()
    k = _randn(dev, B, Sk, Hk, hd, dtype=dtype, seed=1).requires_grad_()
    v = _randn(dev, B, Sk, Hk, hd, dtype=dtype, seed=2).requires_grad_()
    do = _randn(dev, B, Sq, H, hd, dtype=dtype, seed=3)
    n = (tfa.launches, tra.bwd_launches)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal=causal),
                              (q, k, v), do)
    assert (tfa.launches, tra.bwd_launches) == (n[0] + 1, n[1] + 1)
    want = torch.autograd.grad(ref.flash_attention(q, k, v, causal=causal),
                               (q, k, v), do)
    for g, w in zip(got, want):
        _close_attention(g, w, dtype)
    with torch.no_grad():
        _, lse = tfa.flash_attention(q, k, v, causal=causal, return_lse=True)
        _, want_lse = ref.flash_attention(q, k, v, causal=causal,
                                          return_lse=True)
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])


@pytest.mark.parametrize("B,Sq,Sk,H,Hk,hd", [
    (1, 257, 257, 4, 2, 16),
    (2, 257, 257, 4, 2, 32),
    (1, 257, 257, 4, 2, 64),
    (1, 257, 257, 8, 2, 128),
    (1, 1000, 1000, 8, 2, 128),
    (1, 100, 300, 4, 1, 64),             # Sq < Sk
])
def test_flash_backward_tensor_cores(dev, B, Sq, Sk, H, Hk, hd):
    """The bf16 flash backward (one-rank ``ring_step_bwd`` on the tensor
    cores) against autograd through the plain flash, at every head dim,
    ragged and with the queries at the end of the keys."""
    bf = torch.bfloat16
    q = _randn(dev, B, Sq, H, hd, dtype=bf).requires_grad_()
    k = _randn(dev, B, Sk, Hk, hd, dtype=bf, seed=1).requires_grad_()
    v = _randn(dev, B, Sk, Hk, hd, dtype=bf, seed=2).requires_grad_()
    do = _randn(dev, B, Sq, H, hd, dtype=bf, seed=3)
    n = tra.bwd_launches
    got = torch.autograd.grad(ops.flash_attention(q, k, v), (q, k, v), do)
    assert tra.bwd_launches == n + 1
    want = torch.autograd.grad(ref.flash_attention(q, k, v), (q, k, v), do)
    for g, w in zip(got, want):
        _close_attention(g, w, bf)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,H,Hk,hd,window,softcap", [
    (1, 300, 300, 4, 2, 24, 100, None),
    (1, 1000, 1000, 8, 2, 120, 300, None),      # danube's head dim
    (2, 257, 257, 4, 1, 120, None, 30.0),
    (1, 300, 300, 8, 2, 64, 70, 20.0),          # window and softcap
    (1, 100, 300, 4, 2, 120, 150, None),        # Sq < Sk, the band
    (2, 200, 200, 4, 4, 40, 64, 5.0),
    (1, 700, 700, 8, 8, 96, None, None),        # phi-3-vision's, MHA
    (1, 100, 300, 4, 4, 96, None, None),        # Sq < Sk, causal
])
def test_flash_backward_window_softcap_any_head_dim_on_card(
        dev, dtype, B, Sq, Sk, H, Hk, hd, window, softcap):
    """The flash backward (one-rank ``ring_step_bwd``) with a window, a
    softcap, both, or neither at head dims between the tile widths (24,
    40, 96, 120), MHA, GQA
    and MQA, ragged and with the queries at the end of the keys, against
    autograd through the plain flash."""
    q = _randn(dev, B, Sq, H, hd, dtype=dtype).requires_grad_()
    k = _randn(dev, B, Sk, Hk, hd, dtype=dtype, seed=1).requires_grad_()
    v = _randn(dev, B, Sk, Hk, hd, dtype=dtype, seed=2).requires_grad_()
    do = _randn(dev, B, Sq, H, hd, dtype=dtype, seed=3)
    kw = dict(causal=True, window=window, softcap=softcap)
    n = tra.bwd_launches
    got = torch.autograd.grad(ops.flash_attention(q, k, v, **kw), (q, k, v),
                              do)
    assert tra.bwd_launches == n + 1
    want = torch.autograd.grad(ref.flash_attention(q, k, v, **kw),
                               (q, k, v), do)
    for g, w in zip(got, want):
        _close_attention(g, w, dtype)


def test_flash_backward_refuses_head_dims_off_the_multiples_of_8(dev):
    q = _randn(dev, 1, 16, 2, 20, dtype=torch.float32)
    z = torch.zeros(1, 1, 16, 2, 20, device=dev)
    lse = torch.zeros(1, 1, 16, 2, device=dev)
    with pytest.raises(ValueError, match="multiples of 8"):
        tra.ring_step_bwd(q[None], q[None], q[None], q[None], lse, lse, z,
                          z.clone(), z.clone(), [(0, 0, 0, 16, 16)])


@pytest.mark.parametrize("arch", ["qwen3-14b", "nemotron-4-15b",
                                  "h2o-danube-3-4b"])
def test_smoke_train_steps_of_the_dense_family_on_card_match_cpu(dev, arch):
    """Three SMOKE reference-route Trainer steps (fp32; danube at S 64,
    past its window of 32) on the card against the CPU from one state,
    with each block's forward twice under remat."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    b = registry.get_bundle(arch, smoke=True)
    seq = 64 if b.cfg.window else 32
    state = init_train_state(b, seed=0, device="cpu")
    losses = []
    for d in ("cpu", dev):
        t = Trainer(b, TrainerConfig(global_batch=2, seq_len=seq),
                    opt_cfg=AdamWConfig(lr=1e-2, warmup_steps=2),
                    state=state, device=d)
        ops.reset_launch_counts()
        losses.append(t.run(3)["losses"])
    counts, L = ops.launch_counts(), b.cfg.num_layers
    qk = 2 * L if b.cfg.qk_norm else 0
    assert counts["rmsnorm"] == 3 * (4 * L + 2 * qk + 1)
    assert counts["rmsnorm_bwd"] == 3 * (2 * L + qk + 1)
    assert counts["flash_attention"] == 3 * 2 * L
    assert counts["ring_step_bwd"] == 3 * L
    gated = b.cfg.act == "swiglu"
    assert counts["swiglu"] == 3 * 2 * L * gated
    assert counts["swiglu_bwd"] == 3 * L * gated
    torch.testing.assert_close(torch.tensor(losses[1]),
                               torch.tensor(losses[0]), **MODEL_TOL)


# ----------------------- whisper-tiny's cross-attention, phi-3-vision --
# the flash kernels without causality where the queries and the keys have
# other lengths: whisper-tiny's cross-attention (decoder rows against the
# encoder's, at training, prefill and Sq 1 at decode; hd 64, the 64 tile)
NON_CAUSAL_CASES = [
    (2, 48, 150, 6, 6, 64),     # Sq < Sk: every q tile sees all keys
    (2, 150, 48, 6, 6, 64),     # Sq > Sk: the hop's offset Sk - Sq < 0
    (8, 1, 150, 6, 6, 64),      # Sq 1: the decode step
    (2, 1, 1500, 6, 6, 64),     # Sq 1 against whisper's 1500 frames
    (1, 448, 1500, 6, 6, 64),   # whisper's training cross shape
    (1, 37, 100, 4, 2, 32),     # GQA, ragged tiles
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,H,Hk,hd", NON_CAUSAL_CASES)
def test_flash_attention_without_causality_at_other_lengths(
        dev, dtype, B, Sq, Sk, H, Hk, hd):
    """The forward with and without lse against the plain version: every
    q tile covers all Sk keys, whatever Sq."""
    q = _randn(dev, B, Sq, H, hd, dtype=dtype)
    k = _randn(dev, B, Sk, Hk, hd, dtype=dtype, seed=1)
    v = _randn(dev, B, Sk, Hk, hd, dtype=dtype, seed=2)
    want, want_lse = ref.flash_attention(q, k, v, causal=False,
                                         return_lse=True)
    n = tfa.launches
    got, lse = tfa.flash_attention(q, k, v, causal=False, return_lse=True)
    _close_attention(got, want, dtype)
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])
    _close_attention(tfa.flash_attention(q, k, v, causal=False), want, dtype)
    assert tfa.launches == n + 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,H,Hk,hd", [
    c for c in NON_CAUSAL_CASES if c[1] > 1])
def test_flash_backward_without_causality_at_other_lengths(
        dev, dtype, B, Sq, Sk, H, Hk, hd):
    """``FlashAttentionFn``'s backward (the one-rank ``ring_step_bwd`` at
    the hop ``(Sk - Sq, 0, 0, Sk, Sq)``, whose offset is negative at Sq >
    Sk) against autograd through the plain flash."""
    q = _randn(dev, B, Sq, H, hd, dtype=dtype).requires_grad_()
    k = _randn(dev, B, Sk, Hk, hd, dtype=dtype, seed=1).requires_grad_()
    v = _randn(dev, B, Sk, Hk, hd, dtype=dtype, seed=2).requires_grad_()
    do = _randn(dev, B, Sq, H, hd, dtype=dtype, seed=3)
    n = (tfa.launches, tra.bwd_launches)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal=False),
                              (q, k, v), do)
    assert (tfa.launches, tra.bwd_launches) == (n[0] + 1, n[1] + 1)
    want = torch.autograd.grad(ref.flash_attention(q, k, v, causal=False),
                               (q, k, v), do)
    for g, w in zip(got, want):
        _close_attention(g, w, dtype)


def _smoke_batch(cfg, gen, S):
    """tokens (2, S), and the frontend stub's input of the family."""
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, S),
                                     generator=gen)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, 45, cfg.d_model), generator=gen)
    else:
        batch["image_embeds"] = torch.randn(
            (2, cfg.n_vision_tokens, cfg.d_model), generator=gen)
    return batch


@pytest.mark.parametrize("arch", ["whisper-tiny", "phi-3-vision-4.2b"])
def test_smoke_encdec_and_vlm_on_card_match_cpu(dev, arch):
    """whisper-tiny and phi-3-vision-4.2b SMOKE, fp32: the forward, the
    prefill (the VLM's cache over its image positions too), every cache
    leaf and 4 decode steps on the card against the CPU; the card's
    launches exact (whisper's cross-attention through the flash kernel at
    prefill and at every decode step)."""
    b = registry.get_bundle(arch, smoke=True)
    cfg = b.cfg
    cpu = b.init(cfg, seed=0, device="cpu")
    gpu = _to(cpu, dev)
    batch = _smoke_batch(cfg, torch.Generator().manual_seed(3), 21)
    S = 21 + cfg.n_vision_tokens
    out = {}
    for tag, p, d in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
        bd = {k: v.to(d) for k, v in batch.items()}
        ops.reset_launch_counts()
        res = [b.forward(p, bd, cfg)[0]]
        last, cache = b.prefill(p, bd, cfg, S + 8)
        res.append(last)
        cache["pos"] = torch.tensor([S, S], device=d)
        tok = torch.argmax(last, -1, keepdim=True)
        for _ in range(4):
            lg, cache = b.decode_step(p, tok, cache, cfg)
            res.append(lg)
            tok = torch.argmax(lg, -1, keepdim=True)
        out[tag] = res + [cache[part][kv] for part in ("kv", "xkv")
                          if part in cache for kv in ("k", "v")]
    for want, got in zip(out["cpu"], out["gpu"]):
        torch.testing.assert_close(got.cpu(), want, **MODEL_TOL)
    counts, L = ops.launch_counts(), cfg.num_layers
    if cfg.family == "encdec":      # 2 passes (forward, prefill), 4 steps
        Le = cfg.n_encoder_layers
        assert counts["flash_attention"] == 2 * (Le + 2 * L) + 4 * L
        assert counts["rmsnorm"] == 2 * (2 * Le + 1 + 3 * L + 1) \
            + 4 * (3 * L + 1)
    else:
        assert counts["flash_attention"] == 2 * L
        assert counts["rmsnorm"] == 6 * (2 * L + 1)
        assert counts["swiglu"] == 6 * L


@pytest.mark.parametrize("arch", ["whisper-tiny", "phi-3-vision-4.2b"])
def test_smoke_encdec_and_vlm_train_steps_on_card_match_cpu(dev, arch):
    """Three SMOKE reference-route Trainer steps (fp32; the batch's frames
    or image embeddings cast by the trainer) on the card against the CPU
    from one state, each layer's forward twice under remat."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    b = registry.get_bundle(arch, smoke=True)
    state = init_train_state(b, seed=0, device="cpu")
    losses = []
    for d in ("cpu", dev):
        t = Trainer(b, TrainerConfig(global_batch=2, seq_len=48),
                    opt_cfg=AdamWConfig(lr=1e-2, warmup_steps=2),
                    state=state, device=d)
        ops.reset_launch_counts()
        losses.append(t.run(3)["losses"])
    counts, cfg = ops.launch_counts(), b.cfg
    L, Le = cfg.num_layers, cfg.n_encoder_layers
    if cfg.family == "encdec":
        assert counts["flash_attention"] == 3 * 2 * (Le + 2 * L)
        assert counts["ring_step_bwd"] == 3 * (Le + 2 * L)
        assert counts["rmsnorm_bwd"] == 3 * (2 * Le + 1 + 3 * L + 1)
    else:
        assert counts["flash_attention"] == 3 * 2 * L
        assert counts["ring_step_bwd"] == 3 * L
        assert counts["swiglu_bwd"] == 3 * L
    torch.testing.assert_close(torch.tensor(losses[1]),
                               torch.tensor(losses[0]), **MODEL_TOL)


def test_wrappers_refuse_inputs_that_need_grad_on_card(dev):
    x = _randn(dev, 4, 64, dtype=torch.float32).requires_grad_()
    with pytest.raises(RuntimeError, match="kernels.ops.rmsnorm"):
        trn.rmsnorm(x, torch.ones(64, device=dev))
    with pytest.raises(RuntimeError, match="kernels.ops.swiglu"):
        tsg.swiglu(x, x)
    u = _randn(dev, 1, 8, 16, dtype=torch.float32).requires_grad_()
    bc = torch.zeros(1, 8, 4, device=dev)
    with pytest.raises(RuntimeError, match="kernels.ops.ssm_scan"):
        tss.ssm_scan(u, u.detach(), bc, bc, torch.zeros(16, 4, device=dev))
    y = ops.rmsnorm(x, torch.ones(64, device=dev))   # the autograd path
    assert y.grad_fn is not None


@pytest.mark.parametrize("route", ["cp", "reference"])
def test_smoke_trainer_on_card_matches_cpu(dev, route):
    from repro_torch.core.plan import ParallelPlan, StagePlacement
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    b = registry.get_bundle("llama3-8b", smoke=True)
    state = init_train_state(b, seed=0, device="cpu")
    plan = (ParallelPlan(stages=(StagePlacement(0, 2, 3, 1, True),),
                         micro_bs=1, global_batch=2, seq_len=96, cp=3,
                         cp_chunks=(40, 31, 25)) if route == "cp" else None)
    losses = []
    for d in ("cpu", dev):
        t = Trainer(b, TrainerConfig(global_batch=2, seq_len=96), plan=plan,
                    opt_cfg=AdamWConfig(lr=1e-2, warmup_steps=2),
                    state=state, device=d)
        ops.reset_launch_counts()
        losses.append(t.run(3)["losses"])
    counts = ops.launch_counts()
    L = b.cfg.num_layers
    assert counts["rmsnorm_bwd"] == 3 * (2 * L + 1)
    assert counts["ring_step_bwd"] == 3 * L * (3 if route == "cp" else 1)
    torch.testing.assert_close(torch.tensor(losses[1]),
                               torch.tensor(losses[0]), **MODEL_TOL)


@pytest.mark.parametrize("vpp,layers", [(1, [3, 1]), (2, [2, 1, 1, 0])])
def test_smoke_pp_loss_and_grads_on_card_match_cpu(dev, vpp, layers):
    """The pipeline loss (SMOKE llama3-8b at 4 layers, fp32, m 4) and its
    gradients on the card against the same call on the CPU, with the
    launches of its valid slots only: each block forward twice (remat)."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim import adamw
    from repro_torch.parallel.pipeline import make_pp_loss_fn

    b = registry.get_bundle("llama3-8b", smoke=True, num_layers=4)
    params = b.init(b.cfg, seed=0, device="cpu")
    data = SyntheticTokens(vocab_size=b.cfg.vocab_size, seq_len=64,
                           global_batch=8).batch_at(0)
    m, L = 4, 4
    loss_fn = make_pp_loss_fn(b.cfg, 2, m, layers_per_stage=layers, vpp=vpp)
    out = []
    for d in ("cpu", dev):
        p = adamw.tree_map(lambda t: t.to(d).requires_grad_(), params)
        batch = {k: torch.from_numpy(v.reshape(m, 2, -1)).to(d)
                 for k, v in data.items()}
        ops.reset_launch_counts()
        loss, _ = loss_fn(p, batch)
        grads = torch.autograd.grad(loss, adamw.tree_leaves(p))
        out.append((loss.detach().cpu(), [g.cpu() for g in grads]))
    assert ops.launch_counts() == dict(
        rmsnorm=m * (4 * L + 1), rmsnorm_bwd=m * (2 * L + 1),
        swiglu=2 * m * L, swiglu_bwd=m * L, flash_attention=2 * m * L,
        ssm_scan=0, ssm_scan_bwd=0, ring_step=0, ring_step_bwd=m * L)
    (cpu_loss, cpu_grads), (card_loss, card_grads) = out
    torch.testing.assert_close(card_loss, cpu_loss, **MODEL_TOL)
    for g, w in zip(card_grads, cpu_grads):
        torch.testing.assert_close(g, w, **MODEL_TOL)


def test_profile_runner_layers_on_card(dev):
    """The profile runner's layer probes on the card: CUDA-event times,
    positive per-layer fwd/bwd, and exactly the kernel launches of
    ``warmup + reps`` forward and step calls at depths 1, 2 (a step runs
    each block's forward twice under remat).  The probes take llama3-8b's
    full width: at the SMOKE width they are launch-bound, and the
    runner's backward (the depth-2 minus depth-1 step, floored at the
    forward's difference, as the JAX runner computes it) read exactly 0
    once when timing noise put the step difference at or below the
    forward's."""
    from repro_torch.profile import ProfiledCostModel, ProfileStore, runner

    kind = runner.device_kind(dev)
    assert kind == torch.cuda.get_device_name(dev).lower().replace(" ", "-")
    store = ProfileStore()
    ops.reset_launch_counts()
    seq, mbs = 512, 1
    runner.bench_layers(store, kind, "llama3-8b", seqs=(seq,),
                        micro_bss=(mbs,), warmup=2, reps=5, verbose=False,
                        smoke=False, device=dev)
    counts, n = ops.launch_counts(), 7
    want = dict.fromkeys(counts, 0)
    for L in (1, 2):
        for k, per in (("rmsnorm", (2 * L + 1) + (4 * L + 1)),
                       ("swiglu", 3 * L), ("flash_attention", 3 * L),
                       ("rmsnorm_bwd", 2 * L + 1), ("swiglu_bwd", L),
                       ("ring_step_bwd", L)):
            want[k] += per * n
    assert counts == want
    shape = {"arch": "llama3-8b", "seq_len": seq, "micro_bs": mbs, "tp": 1}
    step = store.get(kind, "layer_step", shape).value
    assert step["fwd_s"] > 0 and step["bwd_s"] > 0
    cfg = registry.get_config("llama3-8b")
    assert ProfiledCostModel(store).layer_time(kind, cfg, seq, mbs, 1) == \
        (step["fwd_s"], step["bwd_s"])


# ------------------------------------------------------- the rank route ----
RANK_SCHEDULES = ("1f1b", "1f1b-eager", "gpipe")
# (virtual layers, schedule, eager slack, vpp): each schedule over (3, 1),
# and interleaved-1f1b at vpp 2 over (2, 1, 1, 0)
RANK_CASES = [([3, 1], s, 1, 1) for s in RANK_SCHEDULES] + \
    [([2, 1, 1, 0], "interleaved-1f1b", 1, 2)]


def _pp_rank_case(layers=(3, 1), vpp=1):
    """SMOKE llama3-8b at 4 layers (fp32), 4 microbatches of 2 x 32, and
    the one-process pipeline's loss and gradients over ``layers`` (per
    virtual stage) on the CPU (``tests/test_torch_pipeline.py`` holds
    those to JAX).  The kernel library is built here first, so that the
    ranks only load it."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import build
    from repro_torch.optim import adamw
    from repro_torch.parallel import pipeline

    build.build()
    b = registry.get_bundle("llama3-8b", smoke=True, num_layers=4)
    params = b.init(b.cfg, seed=0, device="cpu")
    data = SyntheticTokens(vocab_size=b.cfg.vocab_size, seq_len=32,
                           global_batch=8).batch_at(0)
    batch = {k: v.reshape(4, 2, 32) for k, v in data.items()}
    p = adamw.tree_map(lambda t: t.clone().requires_grad_(), params)
    loss, _ = pipeline.make_pp_loss_fn(b.cfg, 2, 4, list(layers), vpp=vpp)(
        p, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, adamw.tree_leaves(p))
    it = iter(grads)
    want = adamw.tree_map(lambda _: next(it), p)
    return (adamw.tree_map(lambda t: t.numpy(), params), batch,
            float(loss.detach()), want)


def _check_rank_grads(res):
    from repro_torch.core.simulator import peak_activation_microbatches
    from repro_torch.optim import adamw
    from repro_torch.parallel import pipeline

    for i, (layers, schedule, slack, vpp) in enumerate(RANK_CASES):
        _, _, loss, want = _pp_rank_case(layers, vpp)
        case = [r[i] for r in res]
        for c in case:
            assert abs(c["loss"] - loss) < MODEL_TOL["atol"]
            assert c["peak_inflight"] == peak_activation_microbatches(
                c["stage"], 2, 4, schedule, slack, vpp=vpp)
        got = pipeline.gather_stage_trees([
            adamw.tree_map(torch.from_numpy, c["grads"]) for c in case],
            layers)
        for g, w in zip(adamw.tree_leaves(got), adamw.tree_leaves(want)):
            torch.testing.assert_close(g, w, **MODEL_TOL)


@pytest.mark.parametrize("transport", ["cpu", "gpu"])
def test_pp_ranks_on_cards_match_cpu(dev, transport):
    """A pp 2 rank step under each schedule, interleaved-1f1b at vpp 2
    included, its stages in two processes: host-staged over gloo on one
    card (``cpu``), or over NCCL with a card a rank (``gpu``, skipped
    below two cards)."""
    from repro_torch.parallel import rank_programs
    from repro_torch.parallel.launch import run_ranks

    if transport == "gpu" and torch.cuda.device_count() < 2:
        pytest.skip("NCCL needs a card a rank: two CUDA devices")
    params, batch, _, _ = _pp_rank_case()
    res = run_ranks(
        rank_programs.pp_loss_and_grads, 2, timeout_s=300,
        backend="gloo" if transport == "cpu" else "cpu:gloo,cuda:nccl",
        device=f"cuda:{dev.index}" if transport == "cpu" else "cuda",
        args=(dict(arch="llama3-8b", smoke=True, num_layers=4), params,
              batch, RANK_CASES, transport))
    _check_rank_grads(res)


def test_dp2_zero1_ranks_on_one_card_match_cpu(dev):
    """pp 1 x dp 2 with ZeRO-1: two replicas on one card, each on half the
    rows, their gradient all-reduces and parameter all-gathers
    host-staged over gloo; three Trainer steps against three of the
    reference route on the CPU from one state, and the replicas'
    parameters equal bit for bit."""
    import numpy as np

    from repro_torch.core.plan import ParallelPlan, StagePlacement
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import rank_programs
    from repro_torch.parallel.launch import run_ranks
    from repro_torch.train import steps
    from repro_torch.train.trainer import Trainer, TrainerConfig

    _pp_rank_case()     # builds the kernels before the ranks start
    kw = dict(arch="llama3-8b", smoke=True, num_layers=4)
    b = registry.get_bundle(**kw)
    plan = ParallelPlan(stages=(StagePlacement(0, 4, 2, 1, True),),
                        micro_bs=4, global_batch=8, seq_len=32,
                        transport="cpu")
    opt = dict(lr=1e-2, warmup_steps=2)
    state = steps.init_train_state(b, seed=0, device="cpu")
    res = run_ranks(rank_programs.trainer_steps, 2, timeout_s=300,
                    device=f"cuda:{dev.index}",
                    args=(kw, plan.to_dict(),
                          adamw.tree_map(lambda t: t.numpy(), state), 3,
                          opt))
    cpu = Trainer(b, TrainerConfig(global_batch=8, seq_len=32),
                  opt_cfg=AdamWConfig(**opt), state=state,
                  device="cpu").run(3)["losses"]
    for r in res:
        torch.testing.assert_close(torch.tensor(r["losses"]),
                                   torch.tensor(cpu), **MODEL_TOL)
    for x, y in zip(adamw.tree_leaves(res[0]["params"]),
                    adamw.tree_leaves(res[1]["params"])):
        np.testing.assert_array_equal(x, y)


def test_gpu_transport_on_one_card_raises(dev):
    """Two ranks on one card asked for NCCL: the run fails, naming the
    host-staged transport, and nothing takes another path."""
    from repro_torch.parallel import rank_programs
    from repro_torch.parallel.launch import run_ranks

    params, batch, _, _ = _pp_rank_case()
    with pytest.raises(RuntimeError, match="transport='cpu'"):
        run_ranks(rank_programs.pp_loss_and_grads, 2, timeout_s=300,
                  device=f"cuda:{dev.index}",
                  args=(dict(arch="llama3-8b", smoke=True, num_layers=4),
                        params, batch, [([3, 1], "1f1b", 1)], "gpu"))


# ------------------------------------------ tensor parallelism on ranks ----
def _tp_rank_cases(transport: str):
    """The pp 1 tp 2 case (``(8, 32)`` tokens) and the pp 2 x tp 2 cases
    under 1f1b and gpipe (4 microbatches of 2 x 32) of
    ``rank_programs.tp_loss_and_grads`` on ``_pp_rank_case``'s SMOKE
    weights and tokens, with the CPU's unsharded loss and gradients of
    each (``tests/test_torch_tp.py`` holds those to JAX)."""
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    params, batch, pp_loss, pp_want = _pp_rank_case()
    kw = dict(arch="llama3-8b", smoke=True, num_layers=4)
    flat = {k: v.reshape(8, 32) for k, v in batch.items()}
    b = registry.get_bundle(**kw)
    p = adamw.tree_map(lambda t: torch.from_numpy(t).requires_grad_(),
                       params)
    loss, _ = steps.make_loss_fn(b)(
        p, {k: torch.from_numpy(v) for k, v in flat.items()})
    it = iter(torch.autograd.grad(loss, adamw.tree_leaves(p)))
    want = adamw.tree_map(lambda _: next(it), p)
    case = dict(bundle_kw=kw, params=params, tp=2, transport=transport,
                slack=1)
    pp1 = dict(case, batch=flat, layers=[4], schedule="1f1b")
    pp2 = [dict(case, batch=batch, layers=[3, 1], schedule=s)
           for s in ("1f1b", "gpipe")]
    return (pp1, float(loss.detach()), want), (pp2, pp_loss, pp_want)


def _check_tp_grads(res, pp: int, loss, want):
    from repro_torch.optim import adamw
    from repro_torch.parallel import pipeline, sharding

    rules = sharding.ShardingRules(
        registry.get_config("llama3-8b", smoke=True, num_layers=4), tp=2)
    for r in res:
        assert abs(r["loss"] - loss) < MODEL_TOL["atol"]
    got = pipeline.gather_stage_trees([sharding.gather_trees(
        [adamw.tree_map(torch.from_numpy, r["grads"])
         for r in res[s * 2:(s + 1) * 2]], rules) for s in range(pp)])
    for g, w in zip(adamw.tree_leaves(got), adamw.tree_leaves(want)):
        torch.testing.assert_close(g, w, **MODEL_TOL)


def test_tp_ranks_on_one_card_match_cpu(dev):
    """pp 1 tp 2, the two model ranks on one card, their all-reduces
    host-staged over gloo: the kernels on each rank's heads and columns
    give the CPU's unsharded loss and gradients."""
    from repro_torch.parallel import rank_programs
    from repro_torch.parallel.launch import run_ranks

    (case, loss, want), _ = _tp_rank_cases("cpu")
    res = run_ranks(rank_programs.tp_loss_and_grads, 2, timeout_s=300,
                    device=f"cuda:{dev.index}", args=([case],))
    _check_tp_grads([r[0] for r in res], 1, loss, want)


def test_cp_ranks_on_one_card_match_cpu(dev):
    """pp 1 cp 2, the two ring ranks on one card, their KV hops and the
    gradients' sum over ``pod`` host-staged over gloo: the ring kernels on
    each rank's chunk (one hop of one rank a launch) give the CPU's
    one-process cp loss and gradients (``tests/test_torch_cp_ranks.py``
    holds those to JAX)."""
    from repro_torch.optim import adamw
    from repro_torch.parallel import context, rank_programs
    from repro_torch.parallel.launch import run_ranks

    params, batch, _, _ = _pp_rank_case()
    kw = dict(arch="llama3-8b", smoke=True, num_layers=4)
    chunks = (20, 12)
    flat = {k: v.reshape(8, 32) for k, v in batch.items()}
    b = registry.get_bundle(**kw)
    p = adamw.tree_map(lambda t: torch.from_numpy(t).requires_grad_(),
                       params)
    loss, _ = context.make_cp_loss_fn(b.cfg, chunks)(
        p, {k: torch.from_numpy(v) for k, v in flat.items()})
    it = iter(torch.autograd.grad(loss, adamw.tree_leaves(p)))
    want = adamw.tree_map(lambda _: next(it), p)
    res = run_ranks(rank_programs.cp_loss_and_grads, 2, timeout_s=300,
                    device=f"cuda:{dev.index}",
                    args=([dict(bundle_kw=kw, params=params, batch=flat,
                                chunks=chunks, tp=1, transport="cpu")],))
    for r in res:
        r = r[0]
        assert abs(r["loss"] - float(loss.detach())) < MODEL_TOL["atol"]
        got = adamw.tree_map(torch.from_numpy, r["grads"])
        for g, w in zip(adamw.tree_leaves(got), adamw.tree_leaves(want)):
            torch.testing.assert_close(g, w, **MODEL_TOL)
        # forward, remat's recompute and backward hops of every block
        assert sum(n[0] == "isend_irecv" for n in r["notes"]) == 4 * 5


def test_cp4_llama3_8b_on_four_cards(dev):
    """llama3-8b at full width, 4 layers, batch 1, as a pp 1 x cp 4 plan
    over NCCL, a ring rank a card (skipped below four cards).  (a) S 4096
    with the one-card cp cell's chunks: step 0 within 1e-5 of the
    one-card cp route on card 0 (run first and freed; the forward runs
    the same kernels on the same rows, the hops copy bits), steps 1-2
    within 2e-2 (the ring backward's dq atomics).  (b) S 32768 with
    ``cp_split(32768, 4)``'s chunks, a sequence whose fp32 logits alone
    (16.8 GB) and their cross-entropy's backward do not fit one card
    beside the 27 GB state: 3 steps, finite losses equal on every rank,
    each rank's peak under 80 GB.  ``-s`` prints each run's losses, step
    times, tokens/s and peaks."""
    import gc
    import json
    import math

    from repro_torch.core.plan import ParallelPlan, StagePlacement
    from repro_torch.core.segmentation import cp_split
    from repro_torch.kernels import build
    from repro_torch.parallel import rank_programs
    from repro_torch.parallel.launch import run_ranks
    from repro_torch.train.trainer import Trainer, TrainerConfig

    _four_cards("the cp 4 ring runs a ring rank a card")
    build.build()       # the ranks then only load the library
    kw = dict(arch="llama3-8b", num_layers=4)

    def plan(seq):
        chunks = tuple(cp_split(seq, 4, attn=1 / seq, lin=0.5))
        return ParallelPlan(stages=(StagePlacement(0, 4, 4, 1, True),),
                            micro_bs=1, global_batch=1, seq_len=seq, cp=4,
                            cp_chunks=chunks, transport="gpu")

    def ranks(p):
        res = run_ranks(rank_programs.pp_train, 4, timeout_s=900,
                        backend="cpu:gloo,cuda:nccl", device="cuda",
                        args=(kw, p.to_dict(), 3))
        step_s = [max(r["step_s"][i] for r in res) for i in range(3)]
        print(json.dumps({
            "seq": p.seq_len, "chunks": p.cp_chunk_sizes,
            "losses": res[0]["losses"], "step_s": step_s,
            "tok_s_steps_1_2": p.seq_len * 2 / sum(step_s[1:]),
            "ranks": [{k: r[k] for k in ("rank", "ring", "losses", "step_s",
                                         "peak_gb", "state_gb", "init_s")}
                      for r in res]}))
        losses = res[0]["losses"]
        assert len(losses) == 3 and all(map(math.isfinite, losses)), losses
        assert all(r["losses"] == losses for r in res)
        assert all(r["ring_equal"] for r in res)
        assert all(r["peak_gb"] < 80 for r in res), \
            [r["peak_gb"] for r in res]
        return losses

    short = plan(4096)
    assert short.cp_chunk_sizes == (1383, 1057, 884, 772)
    one = Trainer(registry.get_bundle(**kw),
                  TrainerConfig(global_batch=1, seq_len=4096),
                  plan=short, device=dev)
    assert one._cp_active()
    want = one.run(3)["losses"]
    del one
    gc.collect()
    torch.cuda.empty_cache()
    got = ranks(short)
    print(json.dumps({"one_card_cp": want, "cp4_ranks": got}))
    assert abs(got[0] - want[0]) < 1e-5, (got, want)
    assert max(abs(a - b) for a, b in zip(got, want)) < 2e-2, (got, want)
    long = plan(32768)
    assert long.cp_chunk_sizes == (11064, 8458, 7067, 6179)
    ranks(long)


def test_pp2_tp2_ranks_on_cards_match_cpu(dev):
    """pp 2 x tp 2 over NCCL, a card a rank (skipped below four cards),
    under 1f1b and gpipe."""
    from repro_torch.parallel import rank_programs
    from repro_torch.parallel.launch import run_ranks

    if torch.cuda.device_count() < 4:
        pytest.skip("pp 2 x tp 2 over NCCL needs a card a rank: four CUDA "
                    "devices")
    _, (cases, loss, want) = _tp_rank_cases("gpu")
    res = run_ranks(rank_programs.tp_loss_and_grads, 4, timeout_s=300,
                    backend="cpu:gloo,cuda:nccl", device="cuda",
                    args=(cases,))
    for i in range(len(cases)):
        _check_tp_grads([r[i] for r in res], 2, loss, want)


def test_gpu_transport_tp_on_one_card_raises(dev):
    """Two model ranks on one card asked for NCCL: the run fails, naming
    the host-staged transport, and nothing takes another path."""
    from repro_torch.parallel import rank_programs
    from repro_torch.parallel.launch import run_ranks

    (case, _, _), _ = _tp_rank_cases("gpu")
    with pytest.raises(RuntimeError, match="axis 'model'.*transport='cpu'"):
        run_ranks(rank_programs.tp_loss_and_grads, 2, timeout_s=300,
                  device=f"cuda:{dev.index}", args=([case],))


def test_embedding_gradient_sums_a_tokens_positions_in_fp32(dev):
    """The embedding's bf16 gradient on the card, where a few tokens fill
    two sequences of 4096 (as a frequent token does a training batch):
    each row is the fp64 sum of its positions' gradients rounded once to
    bf16 (``transformer._embed`` looks the rows up; indexing's backward
    adds the positions one at a time into the bf16 gradient, whose error
    ``-s`` prints beside it)."""
    from repro_torch.models import transformer

    cfg = registry.get_config("llama3-8b", smoke=True, dtype="bfloat16",
                              param_dtype="bfloat16")
    V, D = 512, 256
    g = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, 40, (2, 4096), generator=g, device=dev)
    table = _randn(dev, V, D, dtype=torch.bfloat16).requires_grad_()
    dy = _randn(dev, 2, 4096, D, dtype=torch.bfloat16, seed=1)
    want = torch.zeros(V, D, dtype=torch.float64, device=dev).index_add_(
        0, tokens.flatten(), dy.reshape(-1, D).double())
    got, = torch.autograd.grad(
        transformer._embed({"embed": table}, tokens, cfg), table, dy)
    indexed, = torch.autograd.grad(table[tokens], table, dy)
    print({"lookup_rel": _rel(got, want), "indexing_rel": _rel(indexed, want)})
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.double(), want.bfloat16().double(),
                               rtol=2 ** -8, atol=1e-6)


# ------------------------------------ the CLI's own plan on four cards ----
CLI_ARGS = ("--seq", "4096", "--global-batch", "8", "--pp", "2", "--steps",
            "3")


def _four_cards(why: str) -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip(f"{why}: four CUDA devices")


@pytest.fixture(scope="module")
def cli_full_depth(tmp_path_factory):
    """One ``torchrun`` of the train CLI over four cards (``CLI_ARGS``):
    its stdout lines and return code."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.kernels import build

    _four_cards("the CLI's pp 2 x dp 2 plan runs a card a rank")
    build.build()       # the ranks then only load the library
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         *CLI_ARGS, "--ckpt-dir", str(tmp_path_factory.mktemp("cli"))],
        cwd=str(root), env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return r.stdout.strip().splitlines()


def test_cli_full_depth_interleaved_plan_on_four_cards(dev, cli_full_depth):
    """``torchrun`` of the train CLI over four cards (skipped below four):
    llama3-8b at its 32 layers, seq 4096, global batch 8, ``--pp 2``: the
    planner's interleaved-1f1bx2 plan over 18 and 14 layers, widened to
    dp 2 (m 4), over NCCL with a card a rank, ZeRO-1 over ``data``.  The
    printed plan, finite losses equal on every rank, and every rank's
    peak under its card's memory; ``-s`` prints the summary."""
    import json
    import math

    lines = cli_full_depth
    plan = [ln for ln in lines if ln.startswith("[train] plan: ")]
    assert plan == ["[train] plan: pp=2 tp=1 dp=2 mbs=1 m=4 "
                    "sched=interleaved-1f1bx2 seg=18-14"], lines[:4]
    summary = json.loads(lines[-1])
    print(json.dumps(summary))
    assert (summary["world"], summary["dp"], summary["pp"]) == (4, 2, 2)
    assert summary["virtual_layers"] == [9, 8, 9, 6]
    losses = summary["rank_losses"]
    assert len(losses) == 4 and all(ls == losses[0] for ls in losses)
    assert len(losses[0]) == 3 and all(map(math.isfinite, losses[0]))
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    assert all(0 < g < card_gb for g in summary["rank_peak_mem_gb"])


def test_cli_full_depth_losses_match_a_1f1b_witness_on_four_cards(
        dev, cli_full_depth):
    """A witness of the CLI's full-depth run: the same stages (18 and 14
    layers), dp 2, m 4, seed, batches and AdamW (the CLI's lr 3e-4 and 20
    warmup steps), under plain 1f1b (vpp 1) on four ranks over NCCL.  The
    two orders run the same layers on the same microbatches, so every
    step's loss agrees within 2e-2 (bf16), a fault of the interleaved
    order, its chunk offsets or its ZeRO-1 slices at this depth aside;
    the replicas' parameters are equal bit for bit.  ``-s`` prints both
    runs."""
    import dataclasses
    import json

    from repro_torch.launch.train import search_plan
    from repro_torch.parallel import rank_programs
    from repro_torch.parallel.launch import run_ranks

    kw = dict(arch="llama3-8b")
    cli = json.loads(cli_full_depth[-1])
    found = search_plan(registry.get_config(**kw), 2, 8, 4096)
    assert found.schedule == "interleaved-1f1b" and found.layers == (18, 14)
    plan = dataclasses.replace(
        found, schedule="1f1b", vpp=1, chunk_layers=None,
        stages=tuple(dataclasses.replace(st, dp=2) for st in found.stages))
    res = run_ranks(rank_programs.pp_train, 4, timeout_s=900,
                    backend="cpu:gloo,cuda:nccl", device="cuda",
                    args=(kw, plan.to_dict(), 3,
                          dict(lr=3e-4, warmup_steps=20)))
    losses, want = res[0]["losses"], cli["rank_losses"][0]
    print(json.dumps({"plan": plan.describe(), "cli": want,
                      "cli_step_s": cli["step_s"],
                      "ranks": [{k: r[k] for k in (
                          "rank", "stage", "replica", "losses",
                          "grad_norms", "step_s", "peak_gb",
                          "replicas_equal")} for r in res]}))
    assert all(r["losses"] == losses for r in res)
    assert all(r["replicas_equal"] for r in res)
    assert max(abs(a - b) for a, b in zip(losses, want)) < 2e-2, \
        (losses, want)


def test_pp_vpp_dp2_ranks_on_four_cards_match_one_process(dev):
    """The planner's interleaved plan (vpp 2) for llama3-8b at full width
    and 8 layers (bf16, seq 4096), widened to dp 2 at global batch 8, on
    four ranks over NCCL, a card a rank, ZeRO-1 over ``data`` (skipped
    below four cards), against the same plan's one-process pipeline on
    one card: every step's loss within 2e-2 (bf16 products over other
    row counts), equal on every rank, and its gradient norm and the
    whole model's fp32 master move within 1e-2, relative; the replicas'
    parameters equal bit for bit; each replica holds half of its stage's
    optimizer state.  ``-s`` prints both runs."""
    import dataclasses
    import gc
    import json
    import math

    from repro_torch.core import cluster as C
    from repro_torch.core import planner
    from repro_torch.kernels import build
    from repro_torch.parallel import rank_programs
    from repro_torch.parallel.launch import run_ranks
    from repro_torch.train.trainer import Trainer, TrainerConfig

    if torch.cuda.device_count() < 4:
        pytest.skip("pp 2 x dp 2 over NCCL needs a card a rank: four CUDA "
                    "devices")
    build.build()
    kw = dict(arch="llama3-8b", num_layers=8)
    cfg = registry.get_config(**kw)
    cluster = C.ClusterSpec(groups=(C.NodeGroup(C.AMD, 1, accel_per_node=1),
                                    C.NodeGroup(C.GPU_A, 1,
                                                accel_per_node=1)))
    found = planner.search(
        cluster, cfg, global_batch=8, seq_len=4096, pp_options=[2],
        tp_options=[1], micro_bs_options=[1, 2], require_fit=False,
        include_tp_comm=False, schedule="interleaved-1f1b",
        vpp_options=[2]).plan
    plan = dataclasses.replace(found, stages=tuple(
        dataclasses.replace(st, dp=2) for st in found.stages))
    assert plan.vpp == 2 and plan.global_batch == 8
    res = run_ranks(rank_programs.pp_train, 4, timeout_s=600,
                    backend="cpu:gloo,cuda:nccl", device="cuda",
                    args=(kw, plan.to_dict(), 3, None, True))
    one = Trainer(registry.get_bundle(**kw),
                  TrainerConfig(global_batch=8, seq_len=4096), plan=plan,
                  device=dev)
    assert one._pipeline_active()
    out, moved = rank_programs.run_steps(one, 3, moves=True)
    # the one-process state off card 0, or the next four-card run on it
    # finds ~57 GB still cached
    del one
    gc.collect()
    torch.cuda.empty_cache()
    want = out["losses"]
    # the whole model's master move a step: every rank's leaves together
    move = [math.sqrt(sum(sum(r["master_moves"][i]) for r in res))
            for i in range(3)]
    want_move = [math.sqrt(sum(m)) for m in moved]
    print(json.dumps({"plan": plan.describe(), "one_process": want,
                      "one_process_grad_norms": out["grad_norms"],
                      "master_move": move, "one_process_move": want_move,
                      "ranks": [{k: r[k] for k in (
                          "rank", "stage", "replica", "losses",
                          "grad_norms", "step_s", "peak_gb", "state_gb",
                          "n_params", "param_bytes", "opt_bytes",
                          "replicas_equal")} for r in res]}))
    losses = res[0]["losses"]
    assert all(r["losses"] == losses for r in res)
    assert all(r["replicas_equal"] for r in res)
    assert max(abs(a - b) for a, b in zip(losses, want)) < 2e-2, \
        (losses, want)
    # at the warmup's rate the losses barely move: the gradient norm and
    # the update are held too (a replica's slice left unchanged would
    # take a quarter of the move's square away)
    for got, ref_ in ((res[0]["grad_norms"], out["grad_norms"]),
                      (move, want_move)):
        assert max(abs(a - b) / b for a, b in zip(got, ref_)) < 1e-2, \
            (got, ref_)
    for r in res:   # bf16 parameters: 12 bytes of ZeRO state each, halved
        assert r["opt_bytes"] - r["opt_whole_bytes"] == \
            (4 * r["n_params"] * len(r["opt_trees"])
             - r["opt_whole_bytes"]) // 2


# ------------------------------------------------------- checkpoints ----
def test_bf16_full_width_leaf_round_trips_on_card(dev, tmp_path):
    """llama3-8b's bf16 embedding (128256 x 4096) saved from the card and
    restored onto it bit for bit, its file a 2-byte void as JAX writes
    bf16."""
    import numpy as np

    from repro_torch.ckpt import checkpoint as ckpt

    cfg = registry.get_config("llama3-8b")
    x = _randn(dev, cfg.vocab_size, cfg.d_model, dtype=torch.bfloat16)
    ckpt.save(str(tmp_path), 1, {"embed": x})
    got, _ = ckpt.restore(str(tmp_path), 1, {"embed": x})
    assert got["embed"].device == x.device and torch.equal(got["embed"], x)
    arr = np.load(tmp_path / "step_00000001" / "arrays" / "0.npy",
                  mmap_mode="r")
    assert arr.dtype.itemsize == 2 and arr.dtype.kind == "V"


def test_reference_restart_on_card(dev, tmp_path):
    """llama3-8b at full width and 2 layers (bf16, batch 1, seq 4096) on
    the reference route: 5 steps saving at step 3, against a new trainer
    that resumes there and takes steps 4-5.  The first loss after the
    resume equals the uninterrupted run's bit for bit (the forward kernels
    use no atomics); the next within 2e-2 (the flash backward sums dq with
    fp32 atomics, so the states part in the last bits)."""
    import gc

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    b = registry.get_bundle("llama3-8b", num_layers=2)
    cfg = TrainerConfig(global_batch=1, seq_len=4096,
                        ckpt_dir=str(tmp_path), ckpt_every=3)
    a = Trainer(b, cfg, device=dev)
    want = a.run(5)["losses"]
    del a
    gc.collect()
    torch.cuda.empty_cache()
    assert ckpt.all_steps(str(tmp_path)) == [3]
    r = Trainer(b, cfg, device=dev)
    assert r.step == 3
    got = r.run(2)["losses"]
    print({"uninterrupted": want, "resumed": got})
    assert got[0] == want[3]
    assert abs(got[1] - want[4]) < 2e-2


def test_cli_full_depth_resumes_on_four_cards(dev, tmp_path):
    """The CLI's 32-layer plan on four cards (``CLI_ARGS``: 3 steps) with
    ``--ckpt-every 2``: the four ranks write one checkpoint of step 2
    (~112 GB), each its own elements, while step 3 runs; a second
    ``torchrun`` of the same CLI resumes there (``start_step`` 2), and its
    step's loss equals the first run's third bit for bit on every rank
    (the restored state is the saved one, and the forward kernels use no
    atomics).  The checkpoint goes to host memory (``/dev/shm``) where
    there is one: a scratch disk may not take it.  ``-s`` prints both
    runs' losses, step times and the save's timings."""
    import json
    import os
    import shutil
    import subprocess
    import sys
    import tempfile
    from pathlib import Path

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.kernels import build

    _four_cards("the CLI's pp 2 x dp 2 plan runs a card a rank")
    build.build()       # the ranks then only load the library
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    shm = Path("/dev/shm")
    d = Path(tempfile.mkdtemp(prefix="repro-ckpt-",
                              dir=shm if shm.is_dir() else tmp_path))
    free = shutil.disk_usage(d).free
    assert CLI_ARGS[-2:] == ("--steps", "3")
    out = []
    try:
        assert free > 120e9, f"{d}: {free / 1e9:.1f} GB free, the " \
            "32-layer checkpoint takes ~112 GB"
        for steps, every in (("3", "2"), ("1", "50")):
            r = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", "4", "-m",
                 "repro_torch.launch.train", *CLI_ARGS[:-1], steps,
                 "--ckpt-every", every, "--ckpt-dir", str(d)],
                cwd=str(root), env=env, capture_output=True, text=True,
                timeout=900)
            assert r.returncode == 0, r.stderr[-4000:]
            out.append(json.loads(r.stdout.strip().splitlines()[-1]))
            assert ckpt.all_steps(str(d)) == [2]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    saved, resumed = out
    print(json.dumps({"dir": str(d), **{k: {"rank_losses": o["rank_losses"],
                      "step_s": o["step_s"], "init_s": o["init_s"],
                      "ckpt": o["ckpt"]} for k, o in (("saved", saved),
                                                     ("resumed", resumed))}}))
    assert (saved["start_step"], saved["steps"]) == (0, 3)
    assert (resumed["start_step"], resumed["steps"]) == (2, 3)
    for got, want in zip(resumed["rank_losses"], saved["rank_losses"]):
        assert got == want[2:], (got, want)


# ------------------------------------------------------ the closed loop ----
def test_tick_events_match_a_synchronized_host_clock(dev):
    """The pipeline loss's tick marks on the card are CUDA events: a mark
    that also synchronizes and reads the host clock after its event (in
    this test only: the step itself never synchronizes) sees the same
    marks in the same order, each tick within 10% + 0.2 ms of the host
    clock's."""
    import time

    from repro_torch.parallel.pipeline import make_pp_loss_fn
    from repro_torch.telemetry import StageTelemetry

    cfg = registry.get_config("llama3-8b", num_layers=2)
    params = registry.bundle_for(cfg).init(cfg, seed=0, device=dev)
    m = 4
    rec = StageTelemetry(2, 1, m, drop_first=False)

    class Both:
        host: list = []

        def mark(self, t, like):
            rec.mark(t, like)
            torch.cuda.synchronize()
            self.host.append((t, time.perf_counter()))

    both = Both()
    fn = make_pp_loss_fn(cfg, 2, m, layers_per_stage=[1, 1], telemetry=both)
    tok = torch.randint(0, cfg.vocab_size, (m, 1, 1024), device=dev)
    with torch.no_grad():
        for _ in range(2):          # warm, then the one read
            both.host.clear()
            fn(params, {"tokens": tok, "labels": tok})
            events = list(rec._events)
            rec.resolve()
    assert [t for t, _ in events] == [t for t, _ in both.host] == \
        list(range(m + 2))
    first = events[0][1]
    ev = [first.elapsed_time(e) / 1e3 for _, e in events]
    host = [h - both.host[0][1] for _, h in both.host]
    for a, b, c, d in zip(ev, ev[1:], host, host[1:]):
        assert abs((b - a) - (d - c)) <= 0.1 * (d - c) + 2e-4, (ev, host)
    assert rec.steps == 2 and len(rec.stage_ticks()) == 2


def test_smoke_replan_on_card_matches_cpu(dev):
    """The SMOKE 6-layer (3, 3) pp trainer with the CLI's cluster and a
    store, 3 steps, a replan off gpu-a at 4x on the analytic search (the
    profile's threshold out of reach, so both devices search alike) and 2
    steps on the new plan: the same plan, and losses within 1e-4 of the
    CPU's."""
    from repro_torch.core.cluster import cli_cluster, cli_search_kw
    from repro_torch.core.plan import ParallelPlan, StagePlacement
    from repro_torch.profile.store import ProfileStore
    from repro_torch.train.steps import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    b = registry.get_bundle("llama3-8b", smoke=True, num_layers=6)
    state = init_train_state(b, seed=0, device="cpu")
    plan = ParallelPlan(stages=(StagePlacement(0, 3, 1, 1, False),
                                StagePlacement(1, 3, 1, 1, True)),
                        micro_bs=2, global_batch=8, seq_len=32)
    out = []
    for d in ("cpu", dev):
        t = Trainer(b, TrainerConfig(global_batch=8, seq_len=32,
                                     replan_profile_min_obs=1e9),
                    plan=plan, state=state, device=d, cluster=cli_cluster(),
                    profile_store=ProfileStore())
        losses = t.run(3)["losses"]
        res = t.replan(t.cluster.degrade("gpu-a", 4.0), global_batch=8,
                       seq_len=32, **cli_search_kw(2))
        losses += t.run(2)["losses"]
        out.append((res.plan.describe(), losses, t.migrations,
                    t.telemetry.steps))
    assert out[0][0] == out[1][0] and out[0][2] == out[1][2]
    assert out[1][3] == 1           # the rebuilt step's first is dropped
    torch.testing.assert_close(torch.tensor(out[1][1]),
                               torch.tensor(out[0][1]), **MODEL_TOL)


def test_rank_replan_over_nccl_on_four_cards(dev, tmp_path):
    """``rank_programs.replan_cases`` (the gloo test's closed loop on
    ranks) on four cards over NCCL, a card a rank: the SMOKE (3, 1) plan
    widened to pp 2 x dp 2, a replan off gpu-a at 4x moved in memory over
    NCCL (ZeRO-1 slices included), and the next step's loss equal bit for
    bit to a fresh rank trainer's on the gathered state (an element in the
    wrong place moves it), on every rank; one plan, the old grid's groups
    released, every rank's store equal."""
    from repro_torch.core.plan import ParallelPlan, StagePlacement
    from repro_torch.kernels import build
    from repro_torch.parallel import rank_programs
    from repro_torch.parallel.launch import run_ranks

    _four_cards("a replan over NCCL runs a card a rank")
    build.build()
    plan = ParallelPlan(stages=(StagePlacement(0, 3, 1, 1, False),
                                StagePlacement(1, 1, 1, 1, True)),
                        micro_bs=1, global_batch=4, seq_len=16)
    assert plan.transport == "gpu"
    res = run_ranks(rank_programs.replan_cases, 4, timeout_s=600,
                    backend="cpu:gloo,cuda:nccl", device="cuda",
                    args=(dict(arch="llama3-8b", smoke=True, num_layers=4),
                          plan.to_dict(), str(tmp_path)))
    r0 = res[0]
    print([{k: r[k] for k in ("plan", "migrations", "next_losses",
                              "fresh_losses", "n_groups", "card_used_gb")}
           for r in res])
    assert ParallelPlan.from_dict(r0["run_plan"]).dps == (2, 2)
    assert all(r["plan"] == r0["plan"] for r in res)
    assert r0["migrations"] == {"memory": 1, "checkpoint": 0}
    assert all(r["next_losses"] == r0["fresh_losses"] for r in res)
    assert all(r["entries"] == r0["entries"] for r in res)
    assert all(r["n_groups"][0] == r["n_groups"][1] for r in res)


@pytest.mark.parametrize("layers", [16, 32])
def test_cli_degrade_replans_on_four_cards(dev, layers):
    """``torchrun`` of the train CLI over four cards (``CLI_ARGS``, 4 steps)
    at ``layers`` of llama3-8b with ``--degrade gpu-a:4@2``: the ranks
    replan after step 2 (rank 0 searches, every rank adopts), move their
    elements to their new ranks over NCCL in memory, and take steps 3-4 on
    the new plan.  The summary has one replan and one in-memory
    migration, the analytic search's plan held to the card's memory
    (``fit_to_card``; gpu-a's layers fewer), widened to dp 2, every rank's
    losses equal and every peak under the card.  No checkpoint
    (``--ckpt-dir ''``): the 32-layer state's ~112 GB would not fit the
    scratch disk.  The elements' places over NCCL are held bit for bit by
    ``test_rank_replan_over_nccl_on_four_cards``.  ``-s`` prints the
    summary."""
    import json
    import math
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.kernels import build

    _four_cards("the CLI's pp 2 x dp 2 plan runs a card a rank")
    build.build()
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         *CLI_ARGS[:-1], "4", "--layers", str(layers), "--degrade",
         "gpu-a:4@2", "--ckpt-dir", ""],
        cwd=str(root), env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    lines = r.stdout.strip().splitlines()
    summary = json.loads(lines[-1])
    print(json.dumps({k: summary[k] for k in (
        "rank_losses", "step_s", "rank_peak_mem_gb", "virtual_layers",
        "migrations", "replans", "dp", "transport")}))
    print("\n".join(ln for ln in lines if ln.startswith("[train] ")))
    first = [ln for ln in lines if ln.startswith("[train] plan: ")]
    rep = [ln for ln in lines if ln.startswith("[train] degraded ")]
    assert len(first) == len(rep) == 1
    assert rep[0].startswith("[train] degraded gpu-a:4.0 -> replanned: pp=2 ")
    assert summary["replans"] == 1
    assert summary["migrations"] == {"memory": 1, "checkpoint": 0}
    assert (summary["world"], summary["dp"], summary["steps"]) == (4, 2, 4)
    # after 2 steps the store holds 3 observations, below the profiled
    # source's 8: the ranks searched analytically, as this process can
    from repro_torch.core import planner
    from repro_torch.core.cluster import cli_cluster, cli_search_kw
    from repro_torch.launch.train import search_plan
    from repro_torch.train.trainer import fit_to_card, widen_plan
    cfg = registry.get_config("llama3-8b", num_layers=layers)
    old = search_plan(cfg, 2, 8, 4096)
    degraded = cli_cluster().degrade("gpu-a", 4.0)
    card, kw = fit_to_card(degraded, cli_search_kw(2),
                           torch.cuda.get_device_properties(0).total_memory
                           / 1e9)
    want = planner.search(card, cfg, global_batch=8, seq_len=4096,
                          baseline_plan=old, **kw).plan
    assert rep[0].split("replanned: ")[1].startswith(
        widen_plan(want, 4).describe())
    assert summary["virtual_layers"] == list(want.virtual_layers)

    def on_gpu_a(p):
        return sum(st.n_layers for st in p.stages
                   if degraded.groups[st.group].device.name == "gpu-a")

    assert on_gpu_a(want) < on_gpu_a(old), (old.describe(), want.describe())
    losses = summary["rank_losses"]
    assert all(x == losses[0] for x in losses), losses
    assert all(map(math.isfinite, losses[0]))
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    assert all(0 < g < card_gb for g in summary["rank_peak_mem_gb"])


# ------------------- the controller, membership and queue C on the cards ----
def _ctl_trainer(d, policy=None, **cfg_kw):
    """The SMOKE 6-layer (3, 3) pp trainer of ``tests/test_adapt.py`` on
    two one-accelerator islands, seed 0, the analytic search (the profile's
    threshold out of reach, so both devices search alike)."""
    from repro_torch.core.cluster import ClusterSpec, GPU_A, AMD, NodeGroup
    from repro_torch.core.plan import ParallelPlan, StagePlacement
    from repro_torch.profile.store import ProfileStore
    from repro_torch.train.steps import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    b = registry.get_bundle("llama3-8b", smoke=True, num_layers=6)
    plan = ParallelPlan(stages=(StagePlacement(0, 3, 1, 1, False),
                                StagePlacement(1, 3, 1, 1, True)),
                        micro_bs=2, global_batch=8, seq_len=32)
    cl = ClusterSpec(groups=(NodeGroup(AMD, 1, accel_per_node=1),
                             NodeGroup(GPU_A, 1, accel_per_node=1)))
    return Trainer(b, TrainerConfig(global_batch=8, seq_len=32,
                                    replan_profile_min_obs=1e9, **cfg_kw),
                   plan=plan, state=init_train_state(b, seed=0, device="cpu"),
                   device=d, cluster=cl, profile_store=ProfileStore(),
                   policy=policy,
                   adapt_search_kw=dict(pp_options=[1, 2], tp_options=[1],
                                        micro_bs_options=[2],
                                        require_fit=False,
                                        include_tp_comm=False,
                                        schedule="1f1b",
                                        explore_orders=False))


def test_controller_and_membership_on_card_match_cpu(dev):
    """The SMOKE pp trainer on the card and on the CPU: gpu-a lost after
    step 3 and rejoined after step 5 (pp 2 -> pp 1 -> the analytic
    search's choice at SMOKE widths: the same plans and events on both,
    losses within 1e-4); then the controller on its own
    after an injected 8x on gpu-a: on both devices it triggers on stage 1,
    searches and migrates, moving layers off gpu-a, the losses before the
    move within 1e-4."""
    from repro_torch.adapt import AdaptConfig, ReplanPolicy

    runs = []
    for d in ("cpu", dev):
        t = _ctl_trainer(d)
        losses = t.run(3)["losses"]
        t.lose_node("gpu-a")
        losses += t.run(2)["losses"]
        lost = t.plan.describe()
        t.join_node("gpu-a")
        losses += t.run(2)["losses"]
        runs.append((lost, t.plan.describe(),
                     [(e.step, e.action) for e in t.adapt_log], losses,
                     dict(t.migrations)))
    (cpu, card) = runs
    print(runs)
    assert cpu[:3] == card[:3] and cpu[4] == card[4]
    assert cpu[0].startswith("pp=1 ")     # one island holds one stage
    torch.testing.assert_close(torch.tensor(card[3]), torch.tensor(cpu[3]),
                               **MODEL_TOL)
    auto = []
    for d in ("cpu", dev):
        policy = ReplanPolicy(AdaptConfig(patience=2, cooldown=4,
                                          baseline_steps=2, ewma=1.0,
                                          min_gain=0.0))
        t = _ctl_trainer(d, policy=policy)
        losses = t.run(4)["losses"]
        t.inject_degrade("gpu-a", 8.0)
        losses += t.run(6)["losses"]
        trig = next(e for e in t.adapt_log if e.action == "trigger")
        mig = next(e for e in t.adapt_log if e.action == "migrate")
        on_gpu_a = sum(st.n_layers for st in t.plan.stages
                       if t.cluster.groups[st.group].device.name == "gpu-a")
        auto.append((trig.detail["stage"], on_gpu_a, losses[:mig.step],
                     t.migrations))
    print(auto)
    for stage, on_gpu_a, _, mig in auto:
        assert stage == 1 and on_gpu_a < 3
        assert mig == {"memory": 1, "checkpoint": 0}
    n = min(len(auto[0][2]), len(auto[1][2]))
    torch.testing.assert_close(torch.tensor(auto[1][2][:n]),
                               torch.tensor(auto[0][2][:n]), **MODEL_TOL)


def _torchrun_cli(*args, timeout=900):
    """``torchrun`` of the train CLI over four cards at llama3-8b's 8
    layers (the CLI's own ``gpipe`` plan, ``CLI_ARGS``), no checkpoint:
    (its stdout lines, its JSON summary)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.kernels import build

    _four_cards("the CLI's pp 2 x dp 2 plan runs a card a rank")
    build.build()       # the ranks then only load the library
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         *CLI_ARGS[:-1], *args, "--layers", "8", "--ckpt-dir", ""],
        cwd=str(root), env=env, capture_output=True, text=True,
        timeout=timeout)
    first = max(r.stderr.find("Traceback"), 0)    # the rank that raised
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[first:first + 6000]
    lines = r.stdout.strip().splitlines()
    return lines, json.loads(lines[-1])


GPIPE_PLAN = "pp=2 tp=1 dp=2 mbs=1 m=4 sched=gpipe seg=53"


def test_cli_gpipe_plan_on_four_cards_matches_a_1f1b_witness(dev):
    """ROADMAP queue C's regression test: the train CLI's own plan for
    llama3-8b at 8 layers on four cards (gpipe, pp 2 x dp 2 over NCCL),
    which stalled before every pair of a grid's groups was connected when
    the grid is made.  It finishes its 3 steps with finite losses equal on
    every rank, within 2e-2 (bf16) of a 1f1b witness of the same stages,
    dp, seed, batches and AdamW on ``run_ranks``."""
    import dataclasses
    import json
    import math

    from repro_torch.launch.train import search_plan
    from repro_torch.parallel import rank_programs
    from repro_torch.parallel.launch import run_ranks

    lines, cli = _torchrun_cli("3")
    assert [ln for ln in lines if ln.startswith("[train] plan: ")] == \
        [f"[train] plan: {GPIPE_PLAN}"], lines[:4]
    losses = cli["rank_losses"]
    assert all(x == losses[0] for x in losses)
    assert len(losses[0]) == 3 and all(map(math.isfinite, losses[0]))
    kw = dict(arch="llama3-8b", num_layers=8)
    found = search_plan(registry.get_config(**kw), 2, 8, 4096)
    assert found.schedule == "gpipe"
    plan = dataclasses.replace(
        found, schedule="1f1b",
        stages=tuple(dataclasses.replace(st, dp=2) for st in found.stages))
    res = run_ranks(rank_programs.pp_train, 4, timeout_s=900,
                    backend="cpu:gloo,cuda:nccl", device="cuda",
                    args=(kw, plan.to_dict(), 3,
                          dict(lr=3e-4, warmup_steps=20)))
    print(json.dumps({"cli": losses[0], "cli_step_s": cli["step_s"],
                      "peaks": cli["rank_peak_mem_gb"],
                      "witness": res[0]["losses"],
                      "witness_step_s": res[0]["step_s"]}))
    assert all(r["losses"] == res[0]["losses"] for r in res)
    assert max(abs(a - b) for a, b in zip(res[0]["losses"], losses[0])) \
        < 2e-2
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    assert all(0 < g < card_gb for g in cli["rank_peak_mem_gb"])


def test_cli_lose_join_on_four_cards(dev, tmp_path):
    """``--lose gpu-a@2 --join gpu-a@4`` on the CLI's 8-layer plan over four
    cards: after step 3 the two gpu-a ranks (the plan's stage on gpu-a)
    send their elements over NCCL and leave (pp 1 x dp 2 on the amd ranks,
    which take the plan's microbatches one at a time; the leaving ranks'
    allocated memory back to ~0 GB while out), after step 5 they come back
    (pp 2 x dp 2); two in-memory migrations, ``tools/validate_elastic.py``
    passing on the events of the rank that led the loss, and every rank's
    losses equal on the steps it took."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    lines, s = _torchrun_cli("6", "--lose", "gpu-a@2", "--join", "gpu-a@4",
                             "--events-out", str(tmp_path / "events.jsonl"))
    log = tmp_path / "run.log"
    log.write_text("\n".join(lines) + "\n")
    print(json.dumps({k: s[k] for k in (
        "rank_losses", "step_s", "rank_peak_mem_gb", "rank_mem_gb",
        "moves", "migrations")}))
    print("\n".join(ln for ln in lines if ln.startswith(("[adapt]",
                                                         "[train]"))))
    losses = s["rank_losses"]
    stayed = [r for r in range(4) if len(losses[r]) == 6]
    left = [r for r in range(4) if r not in stayed]
    assert len(stayed) == len(left) == 2, losses
    full = losses[stayed[0]]
    for r in stayed:
        assert losses[r] == full
    for r in left:         # out for steps 4 and 5
        assert losses[r] == full[:3] + full[5:]
        assert s["rank_mem_gb"][r][1] < 0.5      # after step 4: released
        assert s["rank_mem_gb"][r][2] > 5        # back after the join
    # the events of the rank that led the loss (the lowest survivor; a
    # follower logs no replan of its own)
    lead = stayed[0]
    events = tmp_path / ("events.jsonl" if lead == 0
                         else f"events.rank{lead}.jsonl")
    root = Path(__file__).resolve().parents[1]
    v = subprocess.run([sys.executable, str(root / "tools" /
                                            "validate_elastic.py"),
                        "--events", str(events), "--run-log", str(log)],
                       capture_output=True, text=True)
    assert v.returncode == 0, v.stdout
    assert s["migrations"] == {"memory": 2, "checkpoint": 0}
    acts = [e["action"] for e in s["adapt_events"]]
    assert acts.count("node-lost") == acts.count("node-joined") == 1
    lost = next(e for e in s["adapt_events"] if e["action"] == "migrate")
    assert lost["detail"]["plan"].startswith("pp=1 ")
    # rank 0's state moves away and back, or in and out
    assert s["moves"][0]["sent_bytes"] + s["moves"][0]["recv_bytes"] > 0
    assert s["moves"][1]["sent_bytes"] + s["moves"][1]["recv_bytes"] > 0


def test_cli_adapt_on_four_cards(dev):
    """``--adapt --degrade gpu-a:4@4`` on the CLI's 8-layer plan over four
    cards: the ranks' telemetry gathered over gloo, the leader's policy
    triggers on gpu-a's stage, searches (held to the card), and every rank
    migrates over NCCL.  (At ``@2`` the injection would land inside the
    policy's two-step healthy baseline and nothing would trigger, in the
    JAX CLI as here.)"""
    import json
    import math

    lines, s = _torchrun_cli("8", "--adapt", "--degrade", "gpu-a:4@4")
    print(json.dumps({k: s[k] for k in ("rank_losses", "step_s",
                                        "rank_peak_mem_gb", "moves",
                                        "adapt_events")}))
    acts = [e["action"] for e in s["adapt_events"]]
    assert "trigger" in acts and "migrate" in acts, acts
    assert s["migrations"] == {"memory": 1, "checkpoint": 0}
    losses = s["rank_losses"]
    assert all(x == losses[0] for x in losses)
    assert len(losses[0]) == 8 and all(map(math.isfinite, losses[0]))


def test_nemotron_tp4_full_width_on_four_cards(dev):
    """nemotron-4-15b at full width (d 6144, 48 / 8 heads, d_ff 24576,
    vocab 256000), 4 layers, one sequence of 4096, as pp 1 x tp 4 over
    NCCL, a rank a card (skipped below four cards; its state does not fit
    one card at any depth: the untied tables alone hold 3.15 B
    parameters): 3 steps with finite losses, the same on every rank, each
    rank's peak under 80 GB.  The witness: the same route at 1 layer, its
    step-0 loss within 2e-2 of the bf16 forward loss one card computes
    for the same weights (seed 0) and batch, with no optimizer state."""
    import gc
    import json
    import math

    from repro_torch.core.plan import ParallelPlan, StagePlacement
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import build
    from repro_torch.parallel import rank_programs
    from repro_torch.parallel.launch import run_ranks
    from repro_torch.train import steps

    _four_cards("nemotron-4-15b's tp 4 runs a card a rank")
    build.build()       # the ranks then only load the library
    arch, seq = "nemotron-4-15b", 4096

    def run(layers, n):
        plan = ParallelPlan(stages=(StagePlacement(0, layers, 1, 4, True),),
                            micro_bs=1, global_batch=1, seq_len=seq,
                            transport="gpu")
        return run_ranks(rank_programs.pp_train, 4, timeout_s=600,
                         backend="cpu:gloo,cuda:nccl", device="cuda",
                         args=(dict(arch=arch, num_layers=layers),
                               plan.to_dict(), n))

    res = run(4, 3)
    print(json.dumps([{k: r[k] for k in ("rank", "losses", "step_s",
                                         "peak_gb", "n_params")}
                      for r in res]))
    losses = res[0]["losses"]
    assert len(losses) == 3 and all(map(math.isfinite, losses)), losses
    assert all(r["losses"] == losses for r in res)
    assert all(r["peak_gb"] < 80 for r in res)
    one = run(1, 1)[0]["losses"][0]
    # the ranks' state is the shards of the seed-0 state, their batch the
    # trainer's first synthetic batch
    b = registry.get_bundle(arch, num_layers=1)
    params = b.init(b.cfg, seed=0, device=dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticTokens(
        vocab_size=b.cfg.vocab_size, seq_len=seq,
        global_batch=1).batch_at(0).items()}
    with torch.no_grad():
        want = float(steps.make_loss_fn(b)(params, batch)[0])
    print(json.dumps({"tp4_step0_loss_1_layer": one, "one_card": want}))
    assert abs(one - want) < 2e-2, (one, want)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
