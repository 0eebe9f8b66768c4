"""The port's plain kernels (``repro_torch.kernels`` on the CPU) against the
JAX package's Pallas kernels in interpret mode and its jnp oracles.

Inputs are made with numpy and rounded to the working dtype the same way
on both sides.  Tolerances are the JAX package's own
(tests/test_kernels.py:15-17): fp32 2e-5 (summation order), bf16 2e-2
(one bf16 rounding of the output).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm  # noqa: E402
from repro.kernels.swiglu import swiglu as pallas_swiglu  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.kernels import swiglu as tsg  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(rng, shape, name):
    """The same values as a jax array and a torch tensor of dtype name."""
    a = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[name]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _close(got_t, want_j, name):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32), **_tol(name))


@pytest.mark.parametrize("B,Sq,Sk,H,Hk,hd", [
    (1, 128, 128, 4, 4, 64),      # MHA square
    (2, 128, 128, 4, 2, 64),      # GQA
    (1, 256, 256, 8, 1, 128),     # MQA, 128 head dim
    (2, 128, 256, 4, 2, 64),      # decode-suffix (Sq < Sk, end-aligned)
])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(B, Sq, Sk, H, Hk, hd, name):
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng, (B, Sq, H, hd), name)
    kj, kt = _pair(rng, (B, Sk, Hk, hd), name)
    vj, vt = _pair(rng, (B, Sk, Hk, hd), name)
    got = ops.flash_attention(qt, kt, vt, causal=True)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    pallas = jfa.flash_attention(qj, kj, vj, causal=True, interpret=True,
                                 block_q=64, block_k=64)
    _close(got, pallas, name)
    _close(got, jref.flash_attention_ref(qj, kj, vj, causal=True), name)


@pytest.mark.parametrize("window", [32, 64])
def test_flash_attention_swa_matches_pallas(window):
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng, (1, 128, 4, 64), "float32")
    kj, kt = _pair(rng, (1, 128, 2, 64), "float32")
    vj, vt = _pair(rng, (1, 128, 2, 64), "float32")
    got = ops.flash_attention(qt, kt, vt, causal=True, window=window)
    _close(got, jfa.flash_attention(qj, kj, vj, causal=True, window=window,
                                    interpret=True, block_q=32, block_k=32),
           "float32")
    _close(got, jref.flash_attention_ref(qj, kj, vj, causal=True,
                                         window=window), "float32")


def test_flash_attention_softcap_matches_pallas():
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng, (1, 128, 2, 64), "float32")
    kj, kt = _pair(rng, (1, 128, 2, 64), "float32")
    vj, vt = _pair(rng, (1, 128, 2, 64), "float32")
    got = ops.flash_attention(qt, kt, vt, causal=True, softcap=30.0)
    _close(got, jfa.flash_attention(qj, kj, vj, causal=True, softcap=30.0,
                                    interpret=True), "float32")


@pytest.mark.parametrize("S,H,Hk,kw", [
    (100, 4, 2, {}),                          # ragged, GQA
    (257, 8, 1, {}),                          # ragged, MQA
    (257, 4, 4, {"window": 50}),              # ragged SWA
    (100, 4, 2, {"softcap": 20.0}),           # ragged softcap
    (100, 4, 2, {"causal": False}),           # bidirectional
])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_flash_attention_ragged_matches_ref(S, H, Hk, kw, name):
    """Lengths the Pallas kernel cannot take (not a multiple of its block):
    held against the jnp oracle alone."""
    rng = np.random.default_rng(3)
    qj, qt = _pair(rng, (2, S, H, 64), name)
    kj, kt = _pair(rng, (2, S, Hk, 64), name)
    vj, vt = _pair(rng, (2, S, Hk, 64), name)
    kw = {"causal": True, **kw}
    _close(ops.flash_attention(qt, kt, vt, **kw),
           jref.flash_attention_ref(qj, kj, vj, **kw), name)


def test_flash_attention_fully_masked_rows_are_zero():
    """Sq > Sk under causality: the first Sq - Sk queries see no key.  The
    port defines them as 0 (the CUDA kernel writes 0 too); every other row
    matches the jnp oracle."""
    rng = np.random.default_rng(4)
    qj, qt = _pair(rng, (2, 40, 4, 32), "float32")
    kj, kt = _pair(rng, (2, 24, 2, 32), "float32")
    vj, vt = _pair(rng, (2, 24, 2, 32), "float32")
    got = ops.flash_attention(qt, kt, vt, causal=True)
    assert torch.count_nonzero(got[:, :16]) == 0
    want = jref.flash_attention_ref(qj, kj, vj, causal=True)
    _close(got[:, 16:], np.asarray(want)[:, 16:], "float32")


@pytest.mark.parametrize("shape", [(2, 37, 64), (300, 256), (4, 128)])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas(shape, name):
    rng = np.random.default_rng(5)
    xj, xt = _pair(rng, shape, name)
    sj, st = _pair(rng, shape[-1:], name)
    got = ops.rmsnorm(xt, st, 1e-5)
    assert got.dtype == xt.dtype
    _close(got, pallas_rmsnorm(xj, sj, 1e-5, interpret=True), name)
    _close(got, jref.rmsnorm_ref(xj, sj, 1e-5), name)


@pytest.mark.parametrize("shape", [(5, 7, 128), (300, 96)])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_swiglu_matches_pallas(shape, name):
    rng = np.random.default_rng(6)
    gj, gt = _pair(rng, shape, name)
    uj, ut = _pair(rng, shape, name)
    got = ops.swiglu(gt, ut)
    assert got.dtype == gt.dtype
    _close(got, pallas_swiglu(gj, uj, interpret=True), name)
    _close(got, jref.swiglu_ref(gj, uj), name)


def test_swiglu_out_dtype_fuses_the_cast():
    """fp32 g/u written straight to bf16 = fp32 result rounded once."""
    rng = np.random.default_rng(7)
    g = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
    got = ops.swiglu(g, u, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.swiglu(g, u).to(torch.bfloat16))


def test_cpu_dispatch_launches_no_kernel():
    """A CPU tensor goes to the plain version: no launch is counted."""
    before = (trn.launches, tsg.launches, tfa.launches)
    x = torch.randn(3, 64)
    ops.rmsnorm(x, torch.ones(64))
    ops.swiglu(x, x)
    q = torch.randn(1, 8, 2, 16)
    ops.flash_attention(q, q, q)
    assert (trn.launches, tsg.launches, tfa.launches) == before


def test_tensor_core_kernels_refuse_unaligned_views():
    """The bf16 kernels copy 16 bytes at a time: a view whose base or a
    stride of a dimension longer than 1 is not on 16 bytes is refused."""
    from repro_torch.kernels import build
    x = torch.zeros(2, 8, 3, 40, dtype=torch.bfloat16)
    build.require_aligned16("k", q=x[..., :32], k=x[:1])   # 80 B, 64 B
    with pytest.raises(ValueError, match="16-byte"):
        build.require_aligned16("k", q=torch.zeros(2, 8, 3, 36,
                                                   dtype=torch.bfloat16)
                                [..., :32])               # 72 B heads
    with pytest.raises(ValueError, match="16-byte"):
        build.require_aligned16("k", q=x.view(-1)[1:65].view(1, 64))
