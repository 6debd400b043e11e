"""The port's flash attention (``core/flash_ref.FlashAttention``, the
reference's custom VJP as a ``torch.autograd.Function``) against
``jax.grad`` through the JAX package's ``flash_attention``, on the same
seeded numpy inputs at float32: GQA, Dv != Dh (MLA), causal and not, a
``q_offset``, S not a multiple of ``kv_chunk`` and T past one query chunk
(512). Stated tolerance: 5e-5 (``tests/test_system.py``'s flash gradient
check) times the largest magnitude of the reference's gradient (at least
1), and 5e-6 for the forward. Also ``attention_auto``'s threshold: dense up
to 1024 positions, flash beyond, on either side the same gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.flash_ref import flash_attention as j_flash
from repro_torch.core import flash_ref
from repro_torch.core.attention import dense_attention

GRAD_TOL = 5e-5
FWD_TOL = 5e-6

CASES = [  # B, T, S, H, KV, Dh, Dv, causal, q_offset, kv_chunk
    (2, 64, 64, 4, 2, 16, 16, True, 0, 32),      # test_system's shape
    (2, 48, 80, 4, 1, 16, 16, True, 32, 32),     # MQA, q_offset, T != S
    (1, 40, 70, 6, 2, 24, 8, True, 30, 32),      # Dv != Dh, S % kv_chunk != 0
    (2, 33, 50, 4, 4, 16, 16, False, 0, 16),     # non-causal, ragged chunks
    (1, 24, 40, 4, 2, 12, 20, False, 0, 64),     # non-causal T < S (cross), one chunk
    (1, 600, 600, 2, 1, 8, 8, True, 0, 256),     # T past one query chunk of 512
    (1, 8, 96, 4, 2, 8, 8, True, 88, 32),        # a chunk's queries at the end of the keys
]


def _inputs(case, seed):
    B, T, S, H, KV, Dh, Dv = case[:7]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, Dh)).astype(np.float32),
            rng.standard_normal((B, S, KV, Dh)).astype(np.float32),
            rng.standard_normal((B, S, KV, Dv)).astype(np.float32),
            rng.standard_normal((B, T, H, Dv)).astype(np.float32))


def _assert_close(got, want, tol, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize("case", CASES)
def test_flash_backward_matches_jax_custom_vjp(case):
    causal, q_offset, kv_chunk = case[7:]
    q, k, v, w = _inputs(case, seed=sum(case[:7]))
    scale = q.shape[-1] ** -0.5

    def f(q, k, v):
        return jnp.sum(j_flash(q, k, v, scale, causal, q_offset, kv_chunk) * w)

    want_out = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal,
                       q_offset, kv_chunk)
    want = jax.grad(f, (0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_ref.flash_attention(tq, tk, tv, scale, causal, q_offset, kv_chunk)
    _assert_close(out, want_out, FWD_TOL, "out")
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for name, g, j in zip("qkv", got, want):
        assert g.dtype == torch.float32 and g.shape == j.shape
        _assert_close(g, j, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("T", [1024, 1040])
def test_attention_auto_gradients_on_either_side_of_the_threshold(T):
    """attention_auto takes the dense oracle at 1024 positions and flash
    attention at 1040; both give dense autograd's gradients."""
    case = (1, T, T, 2, 1, 8, 8)
    q, k, v, w = _inputs(case, seed=T)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = torch.autograd.grad(
        (flash_ref.attention_auto(tq, tk, tv, 0.35) * torch.from_numpy(w)).sum(), (tq, tk, tv))
    dq, dk, dv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    want = torch.autograd.grad(
        (dense_attention(dq, dk, dv, 0.35, causal=True) * torch.from_numpy(w)).sum(),
        (dq, dk, dv))
    for g, r in zip(got, want):
        _assert_close(g, r.detach().numpy(), GRAD_TOL, f"T={T}")
