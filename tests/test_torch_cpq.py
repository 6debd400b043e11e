"""The port's CPQ compression (``repro_torch.core.cpq``) against the JAX
package's, on the same numpy inputs in float32. The JAX functions run
jitted, as the serving engine runs them: XLA then fuses ``a * b + c`` and
divides by the constant step count through its reciprocal, and the port
follows that. Codes, levels and level counts are identical; scale, zero
and prune thresholds agree to rtol 1e-6 (and are in fact identical)."""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import CPQCfg as JCPQCfg
from repro.core import cpq as J
from repro_torch.configs import CPQCfg
from repro_torch.core import cpq as T

EXACT = ("codes", "level", "num_levels")


def _check(t_out, j_out, names):
    for name, t, j in zip(names, t_out, j_out):
        t, j = t.numpy(), np.asarray(j)
        if name in EXACT:
            np.testing.assert_array_equal(t, j, err_msg=name)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=0, err_msg=name)


def _cfgs(bits, **kw):
    return CPQCfg(bits=bits, **kw), JCPQCfg(bits=bits, **kw)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n,n_max", [(13, 13), (13, 20), (1, 4)])
def test_compress_prefill_matches_jax(bits, n, n_max):
    """Padded arenas (n < n_max) included."""
    tcfg, jcfg = _cfgs(bits)
    x = np.random.default_rng(bits + n).normal(size=(2, n, 3, 16)).astype(np.float32)
    j = jax.jit(partial(J.cpq_compress_prefill, cfg=jcfg, n_max=n_max))(jnp.asarray(x))
    t = T.cpq_compress_prefill(torch.tensor(x), tcfg, n_max)
    _check(t, j, T.CPQTensor._fields)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("valid", range(1, 9))
def test_fit_chunk_matches_jax(bits, valid):
    """The masked level-0 fit of a first chunk of C = 8, valid 1..C."""
    tcfg, jcfg = _cfgs(bits)
    x = np.random.default_rng(valid).normal(size=(1, 8, 2, 16)).astype(np.float32)
    j = list(jax.jit(partial(J.cpq_fit_chunk, cfg=jcfg))(
        jnp.asarray(x), jnp.asarray(valid, jnp.int32)))
    t = list(T.cpq_fit_chunk(torch.tensor(x), valid, tcfg))
    j[0], t[0] = np.asarray(j[0])[:, :valid], t[0][:, :valid]  # padding codes are garbage
    j[1], t[1] = np.asarray(j[1])[:, :valid], t[1][:, :valid]
    _check(t, j, ("codes", "level", "scale", "zero", "num_levels", "prune_thr"))


@pytest.mark.parametrize("bits", [4, 8])
def test_encode_token_spawns_to_the_cap_and_reuses(bits):
    """A stream of decode tokens: in-range tokens reuse the current level,
    wide ones spawn levels until ``max_levels``, after which they clip into
    the last level. Every step is identical in both packages."""
    tcfg, jcfg = _cfgs(bits, max_levels=3)
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
    j = jax.jit(partial(J.cpq_compress_prefill, cfg=jcfg, n_max=12))(jnp.asarray(x))
    t = T.cpq_compress_prefill(torch.tensor(x), tcfg, 12)
    js = (j.scale, j.zero, j.num_levels)
    ts = (t.scale, t.zero, t.num_levels)
    enc = jax.jit(partial(J.cpq_encode_token, cfg=jcfg))
    reused = spawned = 0
    for step, amp in enumerate((0.3, 0.5, 4.0, 0.2, 9.0, 0.4, 20.0, 30.0, 0.1)):
        x_t = (amp * rng.normal(size=(2, 1, 2, 16))).astype(np.float32)
        jo = enc(*js, j.prune_thr, x_t=jnp.asarray(x_t))
        to = T.cpq_encode_token(*ts, t.prune_thr, torch.tensor(x_t), tcfg)
        _check(to, jo, ("codes", "level", "scale", "zero", "num_levels"))
        grew = (to[4] > ts[2]).sum().item()
        spawned += grew
        reused += to[4].numel() - grew
        js, ts = jo[2:], to[2:]
    assert spawned > 0 and reused > 0
    assert (ts[2] == 3).all()  # every head reached the cap


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("valid", [1, 5, 8])
def test_encode_chunk_matches_jax(bits, valid):
    """A continuation chunk, token by token, from a fitted first chunk."""
    tcfg, jcfg = _cfgs(bits)
    rng = np.random.default_rng(10 + valid)
    x0 = rng.normal(size=(1, 8, 2, 16)).astype(np.float32)
    x1 = (2.0 * rng.normal(size=(1, 8, 2, 16))).astype(np.float32)
    _, _, scale, zero, nl, thr = J.cpq_fit_chunk(jnp.asarray(x0), jnp.asarray(8), jcfg)
    j = list(jax.jit(partial(J.cpq_encode_chunk, cfg=jcfg))(
        scale, zero, nl, thr, jnp.asarray(x1), jnp.asarray(valid, jnp.int32)))
    side = [torch.tensor(np.asarray(a)) for a in (scale, zero, nl, thr)]
    t = list(T.cpq_encode_chunk(*side, torch.tensor(x1), valid, tcfg))
    for i in (0, 1):
        j[i], t[i] = np.asarray(j[i])[:, :valid], t[i][:, :valid]
    _check(t, j, ("codes", "level", "scale", "zero", "num_levels"))


def test_dequant_and_bytes_per_token_match_jax():
    cfg, jcfg = _cfgs(4)
    x = np.random.default_rng(3).normal(size=(2, 9, 2, 16)).astype(np.float32)
    j = jax.jit(partial(J.cpq_compress_prefill, cfg=jcfg, n_max=9))(jnp.asarray(x))
    t = T.cpq_compress_prefill(torch.tensor(x), cfg, 9)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ref = jax.jit(partial(J.cpq_dequant, dtype=jdtype))(j)
        np.testing.assert_array_equal(T.cpq_dequant(t, dtype).float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
    assert T.cpq_bytes_per_token(cfg, 16, 64) == J.cpq_bytes_per_token(jcfg, 16, 64)
    assert T.cpq_bytes_per_token(cfg, 2, 8, 0.3) == J.cpq_bytes_per_token(jcfg, 2, 8, 0.3)
