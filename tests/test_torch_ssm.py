"""The port's Mamba-1 path (falcon-mamba-7b) against the JAX package on the
CPU, fp32, with inputs made from numpy seeds.

  (a) the plain scan ``ref.ssm_scan`` against the Pallas ``ssm_scan`` in
      interpret mode, at the shapes of tests/test_kernels.py:87-91;
  (b) the plain scan against JAX's ``ssm_scan_ref`` at ragged S, and its
      last state against a float64 numpy step loop;
  (c) the SMOKE model with ``from_jax`` weights: ``lm_forward``,
      ``lm_prefill`` logits and its ``ssm`` cache, and 4 decode steps,
      against JAX at S in {64, 256, 300} (lengths JAX's chunked scan takes);
  (d) prefilling S tokens against prefilling S-4 and decoding 4, at
      S in {37, 500}: lengths JAX cannot prefill (its scan reshapes S into
      ``S // 128`` equal chunks);
  (e) greedy engine streams against ``decode_sequential`` and against the
      JAX engine on the same trace and weights.

Tolerances: the scan at 2e-4, as tests/test_kernels.py:102-103 (a
sequential fp32 loop against a chunked or associative one: the state is a
sum of up to S decayed terms, added in another order); the model at 1e-4,
as tests/test_torch_model.py.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan as pallas_ssm_scan  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import scripted_trace as jax_trace  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import convert, mamba  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.serve import (ServeEngine, decode_sequential,  # noqa: E402
                               scripted_trace)

SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "falcon-mamba-7b"
MAX_LEN = 1024


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's in-process port code (SMOKE
    sizes gain nothing from more), so that test workers running side by
    side do not oversubscribe the host's cores; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _scan_inputs(B, S, di, ds, seed=0):
    """numpy fp32 inputs shaped like the model's: dt > 0, A < 0."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)) - 1.0)) \
        .astype(np.float32)
    Bc = rng.standard_normal((B, S, ds)).astype(np.float32)
    Cc = rng.standard_normal((B, S, ds)).astype(np.float32)
    A = -np.exp(rng.standard_normal((di, ds)) * 0.3).astype(np.float32)
    return u, dt, Bc, Cc, A


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


# ------------------------------------------------------------- (a), (b) --
@pytest.mark.parametrize("B,S,di,ds,chunk,dib", [
    (1, 64, 64, 8, 16, 32),
    (2, 128, 128, 16, 64, 64),
    (1, 256, 64, 4, 128, 64),
])
def test_plain_scan_matches_pallas(B, S, di, ds, chunk, dib):
    arrays = _scan_inputs(B, S, di, ds)
    want = pallas_ssm_scan(*map(jnp.asarray, arrays), chunk=chunk,
                           di_block=dib, interpret=True)
    y, h = ops.ssm_scan(*_torch(*arrays))
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, di) and h.shape == (B, di, ds)
    _close(y, want, SCAN_TOL)


def _step_loop_f64(u, dt, Bc, Cc, A):
    """Last state of the recurrence, float64, one step at a time."""
    u, dt, Bc, Cc, A = (a.astype(np.float64) for a in (u, dt, Bc, Cc, A))
    h = np.zeros((u.shape[0], u.shape[2], A.shape[1]))
    for t in range(u.shape[1]):
        h = np.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * u[:, t])[..., None] * Bc[:, t, None, :]
    return h


@pytest.mark.parametrize("S", [37, 300, 500])
def test_plain_scan_ragged_matches_oracle(S):
    arrays = _scan_inputs(2, S, 48, 16, seed=S)
    want = jref.ssm_scan_ref(*map(jnp.asarray, arrays))
    y, h = ref.ssm_scan(*_torch(*arrays))
    _close(y, want, SCAN_TOL)
    _close(h, _step_loop_f64(*arrays), SCAN_TOL)


def test_plain_scan_reads_bf16_u_and_empty_sequences():
    u, dt, Bc, Cc, A = _torch(*_scan_inputs(1, 20, 16, 16, seed=7))
    ub = u.to(torch.bfloat16)
    y, h = ref.ssm_scan(ub, dt, Bc, Cc, A)
    y32, h32 = ref.ssm_scan(ub.float(), dt, Bc, Cc, A)
    assert torch.equal(y, y32) and torch.equal(h, h32)
    y0, h0 = ref.ssm_scan(u[:, :0], dt[:, :0], Bc[:, :0], Cc[:, :0], A)
    assert y0.shape == (1, 0, 16) and not h0.any()


# ----------------------------------------------------------------- model --
@pytest.fixture(scope="module")
def models():
    jb = jreg.get_bundle(ARCH, smoke=True)
    jp = jb.init(jax.random.PRNGKey(0), jb.cfg)
    tp = convert.from_jax(jax.tree_util.tree_map(np.asarray, jp),
                          device="cpu")
    tb = treg.get_bundle(ARCH, smoke=True)
    return jb, jp, tb, tp


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S),
                                                dtype=np.int32)


def test_config_copied_field_for_field(models):
    jb, _, tb, _ = models
    for f in ("family", "num_layers", "d_model", "vocab_size", "ssm_state",
              "ssm_conv", "ssm_expand", "d_inner", "dt_rank_", "norm_eps",
              "param_dtype", "dtype", "tie_embeddings"):
        assert getattr(tb.cfg, f) == getattr(jb.cfg, f), f
    full_j, full_t = jreg.get_config(ARCH), treg.get_config(ARCH)
    assert (full_t.num_layers, full_t.d_model, full_t.d_inner,
            full_t.ssm_state, full_t.dt_rank_, full_t.ssm_conv,
            full_t.vocab_size) == (64, 4096, 8192, 16, 256, 4, 65024)
    assert full_t.param_count() == full_j.param_count()
    assert full_t.pdtype == torch.bfloat16 and full_t.adtype == torch.bfloat16


def test_init_and_from_jax_keep_the_jax_tree(models):
    """init_lm builds JAX's tree of shapes and dtypes (A_log and D fp32)
    minus the ``_stacked`` marker, and from_jax copies the values."""
    _, jp, tb, tp = models
    mine = tb.init(tb.cfg, seed=0, device="cpu")

    def shapes(node):
        if isinstance(node, dict):
            return {k: shapes(v) for k, v in node.items()}
        return (tuple(node.shape), node.dtype)

    assert shapes(mine) == shapes(tp)
    assert "_stacked" not in tp
    assert tp["blocks"]["ssm"]["A_log"].dtype == torch.float32
    assert tp["blocks"]["ssm"]["D"].dtype == torch.float32
    np.testing.assert_array_equal(tp["blocks"]["ssm"]["A_log"].numpy(),
                                  np.asarray(jp["blocks"]["ssm"]["A_log"]))
    bf = treg.get_config(ARCH, smoke=True, param_dtype="bfloat16")
    p = mamba.init_mamba(torch.Generator().manual_seed(0), bf, 3)
    assert p["in_proj"].dtype == torch.bfloat16
    assert p["A_log"].dtype == p["D"].dtype == torch.float32
    assert torch.equal(p["A_log"][2, 5], torch.log(torch.arange(1.0, 5.0)))


@pytest.mark.parametrize("S", [64, 256, 300])
def test_model_matches_jax(models, S):
    """forward, prefill (logits, h, conv) and 4 decode steps at B=2."""
    jb, jp, tb, tp = models
    tok = _tokens(2, S, seed=S)
    jl, _ = jb.forward(jp, {"tokens": jnp.asarray(tok)}, jb.cfg)
    tl, aux = tb.forward(tp, {"tokens": torch.from_numpy(tok)}, tb.cfg)
    assert tl.shape == (2, S, 256) and float(aux) == 0.0
    _close(tl, jl, MODEL_TOL)

    jl, jc = jb.prefill(jp, {"tokens": jnp.asarray(tok)}, jb.cfg, MAX_LEN)
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(tok)}, tb.cfg,
                        MAX_LEN)
    assert set(tc) == set(jc) == {"pos", "ssm"}
    _close(tl, jl, MODEL_TOL)
    _close(tc["ssm"]["h"], jc["ssm"]["h"], MODEL_TOL)
    _close(tc["ssm"]["conv"], jc["ssm"]["conv"], MODEL_TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == S

    # per-row positions, as the engine keeps them; the ssm path ignores pos
    jc["pos"] = jnp.asarray([S, S - 3], jnp.int32)
    tc["pos"] = torch.tensor([S, S - 3])
    step_toks = _tokens(4, 2, seed=3)
    for t in range(4):
        nxt = step_toks[t][:, None]
        jl, jc = jb.decode_step(jp, jnp.asarray(nxt), jc, jb.cfg)
        tl, tc = tb.decode_step(tp, torch.from_numpy(nxt), tc, tb.cfg)
        assert tl.shape == (2, 256)
        _close(tl, jl, MODEL_TOL)
    _close(tc["ssm"]["h"], jc["ssm"]["h"], MODEL_TOL)
    _close(tc["ssm"]["conv"], jc["ssm"]["conv"], MODEL_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("S", [37, 500])
def test_prefill_equals_prefill_then_steps(models, S):
    """Prefilling S tokens gives the logits and state of prefilling S-4
    and decoding the last 4 one at a time."""
    _, _, tb, tp = models
    tok = torch.from_numpy(_tokens(2, S, seed=S).astype(np.int64))
    want_l, want_c = tb.prefill(tp, {"tokens": tok}, tb.cfg, MAX_LEN)
    got_l, got_c = tb.prefill(tp, {"tokens": tok[:, :S - 4]}, tb.cfg,
                              MAX_LEN)
    for t in range(S - 4, S):
        got_l, got_c = tb.decode_step(tp, tok[:, t:t + 1], got_c, tb.cfg)
    _close(got_l, want_l.numpy(), MODEL_TOL)
    _close(got_c["ssm"]["h"], want_c["ssm"]["h"].numpy(), MODEL_TOL)
    _close(got_c["ssm"]["conv"], want_c["ssm"]["conv"].numpy(), MODEL_TOL)
    assert int(got_c["pos"]) == int(want_c["pos"]) == S


# ---------------------------------------------------------------- engine --
def test_greedy_engine_streams_equal_sequential_and_jax(models):
    """Staggered arrivals into a batch of 3: each row's state is copied
    into its slot by the engine's ``_insert_row``; a wrong copy would part
    the streams from decoding alone."""
    jb, jp, tb, tp = models
    reqs = scripted_trace(8, vocab_size=256, seed=3,
                          prompt_lens=(6, 12, 24), gen_lens=(4, 8, 16))
    jreqs = jax_trace(8, vocab_size=256, seed=3, prompt_lens=(6, 12, 24),
                      gen_lens=(4, 8, 16))
    got = ServeEngine(tb, tp, max_batch=3, max_len=48,
                      device="cpu").run(reqs)
    streams = {c.rid: c.tokens for c in got.completions}
    assert streams == decode_sequential(tb, tp, reqs, max_len=48,
                                        device="cpu")
    want = JaxServeEngine(jb, jp, max_batch=3, max_len=48).run(jreqs)
    assert streams == {c.rid: c.tokens for c in want.completions}
    assert got.decode_steps == want.decode_steps


def test_cli_serves_falcon_mamba_smoke_on_cpu(capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--requests", "3", "--max-batch", "2"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["arch"] == "falcon-mamba-7b-smoke"
    assert summary["requests"] == 3 and summary["device"] == "cpu"
    assert summary["kernel_launches"]["ssm_scan"] == 0   # plain on the CPU
