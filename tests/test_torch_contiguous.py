"""The port's contiguous path against the JAX package's, in float32 on the
same numpy inputs: the cache containers and their traffic accounting, the
contiguous CPQ append (bit-exact against the jitted JAX function, as the
static engine runs it), ``prefill_into_cache`` and ``decode_attend`` in
every ported mode (with the contiguous kernels' plain versions and with the
plain path; outputs within 1e-5), ``attention_auto`` on both sides of its
flash threshold, and the one-shot admission pack (``pack_into``), bucket
padding past the slot's capacity included. The JAX side runs jitted."""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import AttentionRuntime as JRuntime
from repro.configs.base import CPQCfg as JCPQCfg
from repro.configs.base import RetrievalCfg as JRetrievalCfg
from repro.core import attention as JA
from repro.core import cpq as JC
from repro.core import flash_ref as JF
from repro.core import kv_cache as JK
from repro.serving import paged_cache as JP
from repro_torch.configs import AttentionRuntime, CPQCfg, RetrievalCfg
from repro_torch.core import attention as TA
from repro_torch.core import cpq as TC
from repro_torch.core import flash_ref as TF
from repro_torch.core import kv_cache as TK
from repro_torch.serving import paged_cache as TP

B, N, S, KV, G, DH, DM, R = 2, 24, 13, 2, 2, 16, 32, 8
MODES = ("dense", "decomposed", "cpq", "retrieval")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _assert_tree(t, j, exact=False, atol=1e-5):
    for a, b in zip(_leaves(t), _leaves(j), strict=True):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
        if exact or a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=1e-5)


def _runtimes(mode, fused=True):
    kw = {"retrieval": dict(top_k=10, recent_window=3), "cpq": {}}.get(mode, {})
    t = AttentionRuntime(mode=mode, paged_kernels=fused,
                         **({"retrieval": RetrievalCfg(**kw)} if mode == "retrieval" else {}))
    j = JRuntime(mode=mode, **({"retrieval": JRetrievalCfg(**kw)} if mode == "retrieval" else {}))
    return t, j


# ------------------------------------------------------------- containers


def test_containers_and_bytes_per_token_match_jax():
    made = [
        (TK.init_dense(B, N, KV, DH, torch.float32),
         JK.init_dense(B, N, KV, DH, jnp.float32)),
        (TK.init_x(B, N, DM, KV, R, torch.float32), JK.init_x(B, N, DM, KV, R, jnp.float32)),
        (TK.init_cpq(B, N, KV, DH, CPQCfg(bits=8)), JK.init_cpq(B, N, KV, DH, JCPQCfg(bits=8))),
        (TK.init_retrieval(B, N, KV, DH, RetrievalCfg(proxy_dim=8), torch.bfloat16),
         JK.init_retrieval(B, N, KV, DH, JRetrievalCfg(proxy_dim=8))),
    ]
    for t, j in made:
        assert type(t).__name__ == type(j).__name__ and t._fields == j._fields
        for a, b in zip(_leaves(t), _leaves(j), strict=True):
            b = np.asarray(b)
            assert tuple(a.shape) == b.shape and str(a.dtype).removeprefix("torch.") == b.dtype.name
            np.testing.assert_array_equal(a.float().numpy(), b.astype(np.float32))
        assert t.length.device.type == "cpu"
        for cfg in (None, (CPQCfg(bits=8, prune_ratio=0.2), JCPQCfg(bits=8, prune_ratio=0.2))):
            assert TK.bytes_per_token(t, cfg and cfg[0]) == JK.bytes_per_token(j, cfg and cfg[1])
    assert TK.valid_mask(TK.host_length(5), 8).tolist() == np.asarray(
        JK.valid_mask(jnp.asarray(5), 8)).tolist()
    lens = np.array([0, 3, 8], np.int32)
    np.testing.assert_array_equal(TK.length_mask(torch.tensor(lens), 8, "cpu").numpy(),
                                  np.asarray(JK.length_mask(jnp.asarray(lens), 8)))
    arena = torch.zeros(2, 6, 3)
    new = torch.ones(2, 2, 3)
    want = JK.append_tokens(jnp.zeros((2, 6, 3)), jnp.ones((2, 2, 3)), jnp.asarray(3))
    np.testing.assert_array_equal(TK.append_tokens(arena, new, 3).numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [4, 8])
def test_cpq_append_decode_bit_exact(bits):
    """Contiguous HQE appends after a prompt fit: in-range tokens reuse the
    level, wide ones (amplitude 6 and 20) open new levels. Codes, levels,
    level counts and tables identical to the jitted JAX function."""
    tcfg, jcfg = CPQCfg(bits=bits, max_levels=4), JCPQCfg(bits=bits, max_levels=4)
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(B, S, KV, DH)).astype(np.float32)
    j = jax.jit(partial(JC.cpq_compress_prefill, cfg=jcfg, n_max=N))(jnp.asarray(x))
    t = TC.cpq_compress_prefill(torch.tensor(x), tcfg, N)
    append = jax.jit(partial(JC.cpq_append_decode, cfg=jcfg))
    for i, amp in enumerate((0.5, 6.0, 0.3, 20.0, 1.0)):
        x_t = (amp * rng.normal(size=(B, 1, KV, DH))).astype(np.float32)
        j = append(j, jnp.asarray(x_t), jnp.asarray(S + i, jnp.int32))
        t = TC.cpq_append_decode(t, torch.tensor(x_t), S + i, tcfg)
        _assert_tree(tuple(t), tuple(j), exact=True)
    assert int(t.num_levels.max()) > 1   # a wide token opened a new level


# ------------------------------------------------- prefill and decode attend


def _inputs(rng, T_):
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return dict(k=f(B, T_, KV, DH), v=f(B, T_, KV, DH), x=f(B, T_, DM), k_rope=f(B, T_, KV, R))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_attend_match_jax(mode, fused):
    """Prefill S tokens into an N-token arena, then three decode appends and
    attends. ``fused`` runs the contiguous kernels' plain versions (B8, B9,
    B10 with rounded tiles, B7), else the plain path; both are held to the
    JAX package's function within 1e-5."""
    rt, jrt = _runtimes(mode, fused)
    rng = np.random.default_rng(len(mode))
    scale = DH ** -0.5
    kw = dict(batch=B, n_max=N, kv=KV, dh=DH, d_model=DM, rope_dims=R)
    t = TA.init_cache(rt, **kw, dtype=torch.float32)
    j = JA.init_cache(jrt, **kw, dtype=jnp.float32)
    inp = _inputs(rng, S)
    t_in = {k: torch.tensor(v) for k, v in inp.items()}
    j_in = {k: jnp.asarray(v) for k, v in inp.items()}
    t = TA.prefill_into_cache(rt, t, **t_in, length=S)
    j = jax.jit(partial(JA.prefill_into_cache, jrt))(j, **j_in, length=jnp.asarray(S, jnp.int32))
    _assert_tree(tuple(t), tuple(j))
    dec = jax.jit(partial(JA.decode_attend, jrt, scale=scale))
    w_k = (rng.normal(size=(DM, KV, DH - R)) / np.sqrt(DM)).astype(np.float32)
    w_v = (rng.normal(size=(DM, KV, DH)) / np.sqrt(DM)).astype(np.float32)
    for _ in range(3):
        step = _inputs(rng, 1)
        q = rng.normal(size=(B, 1, KV * G, DH)).astype(np.float32)
        t1 = dict(x_t=step["x"], k_rope_t=step["k_rope"], q_nope=q[..., R:],
                  q_rope=q[..., :R], w_k_nope=w_k, w_v=w_v) if mode == "decomposed" else {}
        args = dict(q=q, k_t=step["k"], v_t=step["v"], **t1)
        t_out, t = TA.decode_attend(rt, t, **{k: torch.tensor(v) for k, v in args.items()},
                                    scale=scale)
        j_out, j = dec(j, **{k: jnp.asarray(v) for k, v in args.items()},
                       **({} if t1 else dict(x_t=None, k_rope_t=None, q_nope=None,
                                             q_rope=None, w_k_nope=None, w_v=None)))
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5, rtol=1e-5)
        _assert_tree(tuple(t), tuple(j))
    assert int(t.length) == S + 3


@pytest.mark.parametrize("T_,S_,causal,threshold", [
    (16, 16, True, 1024), (1, 20, False, 1024),      # the dense oracle
    (40, 40, True, 16), (24, 40, False, 16),         # the flash forward
])
def test_attention_auto_matches_jax(T_, S_, causal, threshold):
    rng = np.random.default_rng(T_ + S_)
    q = rng.normal(size=(2, T_, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, S_, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, S_, 2, 8)).astype(np.float32)
    want = JF.attention_auto(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25,
                             causal=causal, flash_threshold=threshold)
    got = TF.attention_auto(torch.tensor(q), torch.tensor(k), torch.tensor(v), 0.25,
                            causal=causal, flash_threshold=threshold)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv_chunk,q_chunk,q_offset", [(16, 8, 0), (7, 32, 5)])
def test_flash_forward_chunks_match_jax(kv_chunk, q_chunk, q_offset):
    """Several query and key chunks, ragged last chunks, a query offset."""
    rng = np.random.default_rng(kv_chunk)
    q = rng.normal(size=(1, 30, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, 37, 4, 16)).astype(np.float32)
    v = rng.normal(size=(1, 37, 4, 16)).astype(np.float32)
    want = JF._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25, True,
                              q_offset, kv_chunk, q_chunk)
    got = TF._flash_fwd_impl(torch.tensor(q), torch.tensor(k), torch.tensor(v), 0.25, True,
                             q_offset, kv_chunk, q_chunk)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------ pack


PAGE, NB, P = 4, 3, 9


def _paged_pair(mode, slots=2):
    """Empty paged arenas of ``mode`` in both packages (tiered: dense + CPQ)."""
    cfg, jcfg = CPQCfg(), JCPQCfg()
    if mode == "dense":
        return (TP.init_paged_dense(P, PAGE, KV, DH, torch.float32),
                JP.init_paged_dense(P, PAGE, KV, DH, jnp.float32))
    if mode == "decomposed":
        return (TP.init_paged_x(P, PAGE, DM, KV, R, torch.float32),
                JP.init_paged_x(P, PAGE, DM, KV, R, jnp.float32))
    if mode == "cpq":
        return (TP.init_paged_cpq(P, PAGE, slots, KV, DH, cfg),
                JP.init_paged_cpq(P, PAGE, slots, KV, DH, jcfg))
    if mode == "retrieval":
        return (TP.init_paged_retrieval(P, PAGE, slots, KV, DH, RetrievalCfg(), torch.float32),
                JP.init_paged_retrieval(P, PAGE, slots, KV, DH, JRetrievalCfg(),
                                        jnp.float32))
    return (TP.TieredPagedCache(_paged_pair("dense")[0], _paged_pair("cpq")[0]),
            JP.TieredPagedCache(_paged_pair("dense")[1], _paged_pair("cpq")[1]))


def _src(mode, rng, n):
    """A B=1 contiguous source of n tokens (prefilled through each
    package's own prefill_into_cache)."""
    rt, jrt = _runtimes(mode)
    kw = dict(batch=1, n_max=n, kv=KV, dh=DH, d_model=DM, rope_dims=R)
    inp = {k: v[:1] for k, v in _inputs(rng, n).items()}
    t = TA.prefill_into_cache(rt, TA.init_cache(rt, **kw, dtype=torch.float32),
                              **{k: torch.tensor(v) for k, v in inp.items()}, length=n)
    j = jax.jit(partial(JA.prefill_into_cache, jrt))(
        JA.init_cache(jrt, **kw, dtype=jnp.float32), **{k: jnp.asarray(v) for k, v in inp.items()},
        length=jnp.asarray(n, jnp.int32))
    return t, j


@pytest.mark.parametrize("n,mapped", [(12, 3), (16, 3), (8, 2)])
@pytest.mark.parametrize("mode", MODES + ("tiered-dense", "tiered-cpq"))
def test_pack_into_matches_jax(mode, n, mapped):
    """One-shot admission packs a prefilled B=1 cache into slot 1's pages.
    n = 16 is a bucket-padded prompt longer than the slot's capacity of
    NB * PAGE = 12 tokens: positions 12-15 must land on the null page, never
    on a mapped page. n = 8 maps 2 of the 3 blocks. Every page but the
    null page (whose contents are garbage by design) and every slot table
    is identical to the JAX package's."""
    rng = np.random.default_rng(n + mapped)
    arena = mode.split("-")[0]
    t_cache, j_cache = _paged_pair(arena)
    src_mode = mode.split("-")[-1] if arena == "tiered" else mode
    t_src, j_src = _src(src_mode, rng, n)
    row = np.zeros(NB, np.int32)
    row[:mapped] = rng.permutation(np.arange(1, P))[:mapped]
    got = TP.pack_into(src_mode, t_cache, t_src, torch.tensor(row), 1)
    want = JP.pack_into(src_mode, j_cache, j_src, jnp.asarray(row), jnp.asarray(1, jnp.int32))
    for a, b in zip(_leaves(tuple(got)), _leaves(tuple(want)), strict=True):
        a, b = _np(a), _np(b)
        if a.shape[0] == P:        # a page pool: skip the null page
            a, b = a[1:], b[1:]
        np.testing.assert_array_equal(a, b)
    pools = [a for a in _leaves(tuple(got)) if a.shape[0] == P]
    for pool in pools:       # pages outside the row stay empty
        unmapped = sorted(set(range(1, P)) - set(row[:mapped].tolist()))
        assert not pool[unmapped].any()
