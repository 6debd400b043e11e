"""T1+T2 (``mode="decomposed_cpq"``: T1's X arena in CPQ codes) of the port
against the JAX package: the containers and their traffic accounting, the
chunked decode ``decomposed_cpq_chunked_decode`` and the chunk prefill
``decomposed_cpq_chunk_prefill``, the contiguous and paged attend paths,
the admission pack and the defrag permutation, then qwen1.5-0.5b served in
this mode by the continuous engine (chunked and one-shot) and by the static
engine. Float32. The decode rounds R and the dequantized tiles to bf16, as
the (jitted) reference does; stated tolerance 1e-4 (outputs and logits)."""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.configs.base import CPQCfg as JCPQCfg
from repro.core import attention as JA
from repro.core import cpq as JC
from repro.core import kv_cache as JK
from repro.serving import paged_cache as JP
from repro.serving.trace import make_workload
import repro_torch as T
from repro_torch.configs import CPQCfg
from repro_torch.core import attention as TA
from repro_torch.core import cpq as TC
from repro_torch.core import kv_cache as TK
from repro_torch.serving import paged_cache as TP
from torch_paged_cases import serve_pair, smoke_pair

TOL = 1e-4
B, N, DM, H, KV, DN, DV, R = 2, 20, 32, 4, 2, 8, 8, 4


def _close(t_out, j_out, tol=TOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), atol=tol, rtol=tol)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _same(t_tree, j_tree):
    for a, b in zip(_leaves(tuple(t_tree)), _leaves(tuple(j_tree)), strict=True):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_containers_and_bytes_per_token_match_jax():
    for cfg in ((CPQCfg(), JCPQCfg()), (CPQCfg(bits=8, prune_ratio=0.2),
                                        JCPQCfg(bits=8, prune_ratio=0.2))):
        t = TK.init_cpq_x(B, N, DM, KV, R, cfg[0], torch.float32)
        j = JK.init_cpq_x(B, N, DM, KV, R, cfg[1], jnp.float32)
        assert type(t).__name__ == type(j).__name__ and t._fields == j._fields
        _same(t[:2], j[:2])
        assert TK.bytes_per_token(t, cfg[0]) == JK.bytes_per_token(j, cfg[1])
        tp = TP.init_paged_cpq_x(9, 4, 3, DM, KV, R, cfg[0], torch.float32)
        jp = JP.init_paged_cpq_x(9, 4, 3, DM, KV, R, cfg[1], jnp.float32)
        _same(tp, jp)
        assert TP.bytes_per_token(tp, 4, cfg[0]) == JP.bytes_per_token(jp, 4, cfg[1])
    assert TP.UNPORTED_MODES == {}


def _x_codes(rng, bits=4, n=N):
    """A CPQ X arena in both packages, compressed from the same random X
    (prefill of 14 tokens, then HQE appends up to ``n``)."""
    tcfg, jcfg = CPQCfg(bits=bits), JCPQCfg(bits=bits)
    x = rng.normal(size=(B, 14, 1, DM)).astype(np.float32)
    t = TC.cpq_compress_prefill(torch.from_numpy(x), tcfg, n)
    j = jax.jit(partial(JC.cpq_compress_prefill, cfg=jcfg, n_max=n))(jnp.asarray(x))
    append = jax.jit(partial(JC.cpq_append_decode, cfg=jcfg))  # bit-exact: jitted
    for i in range(14, n):
        x_t = (rng.normal(size=(B, 1, 1, DM)) * (1 + 3 * (i % 3 == 0))).astype(np.float32)
        t = TC.cpq_append_decode(t, torch.from_numpy(x_t), i, tcfg)
        j = append(j, jnp.asarray(x_t), jnp.asarray(i, jnp.int32))
    _same(t, j)
    return t, j


@pytest.mark.parametrize("length,chunk,kv_r,rr", [
    (N, 2048, KV, R),                  # every token, one chunk
    (11, 8, KV, R),                    # past the prefill, across chunks of 8
    ([20, 3], 8, 1, R),                # per-row lengths, one shared roped key (MLA)
    ([7, 0], 6, KV, 0),                # no rope, an empty row
])
def test_chunked_decode_matches_jax(length, chunk, kv_r, rr):
    rng = np.random.default_rng(rr + kv_r + chunk)
    t_x, j_x = _x_codes(rng)
    q = rng.normal(size=(B, 1, H, DN + rr)).astype(np.float32)
    kr = rng.normal(size=(B, N, kv_r, rr)).astype(np.float32)
    wk = (rng.normal(size=(DM, KV, DN)) / np.sqrt(DM)).astype(np.float32)
    wv = (rng.normal(size=(DM, KV, DV)) / np.sqrt(DM)).astype(np.float32)
    ln = np.asarray(length, np.int32)
    got = TA.decomposed_cpq_chunked_decode(
        torch.from_numpy(q[..., :DN]), torch.from_numpy(q[..., DN:]) if rr else None, t_x,
        torch.from_numpy(kr), torch.from_numpy(wk), torch.from_numpy(wv),
        torch.from_numpy(ln), 0.3, chunk=chunk)
    want = jax.jit(partial(JA.decomposed_cpq_chunked_decode, scale=0.3, chunk=chunk))(
        jnp.asarray(q[..., :DN]), jnp.asarray(q[..., DN:]) if rr else None, j_x,
        jnp.asarray(kr), jnp.asarray(wk), jnp.asarray(wv), jnp.asarray(ln))
    assert got.shape == (B, 1, H, DV)
    live = np.broadcast_to(ln, (B,)) > 0   # an empty row's output is garbage in both
    _close(got[live], np.asarray(want)[live])


def _rt(mode="decomposed_cpq", fused=True):
    return (T.AttentionRuntime(mode=mode, cpq=CPQCfg(), paged_kernels=fused),
            jconfigs.AttentionRuntime(mode=mode, cpq=JCPQCfg(), paged_kernels=fused))


@pytest.mark.parametrize("fused", [True, False])
def test_contiguous_prefill_and_decode_attend_match_jax(fused):
    """``prefill_into_cache`` compresses the prompt's X (level 0 over the
    whole prompt); three ``decode_attend`` steps HQE-append X and run the
    chunked decode (no kernel: the same path with the kernels on)."""
    rt, jrt = _rt(fused=fused)
    rng = np.random.default_rng(4)
    S, scale = 9, 0.25
    kw = dict(batch=B, n_max=N, kv=KV, dh=DN + R, d_model=DM, rope_dims=R)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    inp = dict(k=f(B, S, KV, DN + R), v=f(B, S, KV, DN + R), x=f(B, S, DM),
               k_rope=f(B, S, KV, R))
    t = TA.prefill_into_cache(rt, TA.init_cache(rt, **kw, dtype=torch.float32),
                              **{k: torch.from_numpy(v) for k, v in inp.items()}, length=S)
    j = jax.jit(partial(JA.prefill_into_cache, jrt))(
        JA.init_cache(jrt, **kw, dtype=jnp.float32), **{k: jnp.asarray(v) for k, v in inp.items()},
        length=jnp.asarray(S, jnp.int32))
    _same(t[:2], j[:2])
    wk = (f(DM, KV, DN) / np.sqrt(DM)).astype(np.float32)
    wv = (f(DM, KV, DN + R) / np.sqrt(DM)).astype(np.float32)
    dec = jax.jit(partial(JA.decode_attend, jrt, scale=scale))
    for _ in range(3):
        q = f(B, 1, H, DN + R)
        args = dict(q=q, k_t=f(B, 1, KV, DN + R), v_t=f(B, 1, KV, DN + R), x_t=f(B, 1, DM),
                    k_rope_t=f(B, 1, KV, R), q_nope=q[..., R:], q_rope=q[..., :R],
                    w_k_nope=wk, w_v=wv)
        t_out, t = TA.decode_attend(rt, t, **{k: torch.from_numpy(v) for k, v in args.items()},
                                    scale=scale)
        j_out, j = dec(j, **{k: jnp.asarray(v) for k, v in args.items()})
        _close(t_out, j_out)
        _same(t[:2], j[:2])
    assert int(t.length) == S + 3


P, PAGE, SLOTS = 11, 4, 3
ROWS = np.array([[6, 2, 9, 0, 0], [3, 10, 1, 7, 4], [0, 0, 0, 0, 0]], np.int32)


@pytest.mark.parametrize("fused", [True, False])
def test_paged_chunks_and_decode_match_jax(fused):
    """``chunk_attend_paged`` streams two slots' prompts in chunks of 8 (the
    first fits level 0, later ones HQE-extend; a partial last chunk) over
    permuted pages through ``decomposed_cpq_chunk_prefill``, then three
    ``decode_attend_paged`` steps with an inactive, unmapped third row."""
    rt, jrt = _rt(fused=fused)
    rng = np.random.default_rng(5)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    t = TP.init_paged_cpq_x(P, PAGE, SLOTS, DM, KV, R, CPQCfg(), torch.float32)
    j = JP.init_paged_cpq_x(P, PAGE, SLOTS, DM, KV, R, JCPQCfg(), jnp.float32)
    wk = (f(DM, KV, DN) / np.sqrt(DM)).astype(np.float32)
    wv = (f(DM, KV, DV) / np.sqrt(DM)).astype(np.float32)
    C, scale, lengths = 8, 0.3, [0, 0, 0]
    tw = dict(w_k_nope=torch.from_numpy(wk), w_v=torch.from_numpy(wv))
    jw = dict(w_k_nope=jnp.asarray(wk), w_v=jnp.asarray(wv))
    for slot, offset, valid in ((1, 0, 8), (0, 0, 6), (1, 8, 8), (1, 16, 3), (0, 6, 5)):
        q = f(1, C, H, DN + R)
        x, kr = f(1, C, DM), f(1, C, KV, R)
        args = dict(q=q, k_c=q[..., :KV, :], v_c=q[..., :KV, :], x_c=x, k_rope_c=kr,
                    q_nope=q[..., R:], q_rope=q[..., :R])
        t_out, t = TP.chunk_attend_paged(rt, t, tier=0, first=offset == 0, slot=slot,
                                         offset=offset, valid=valid, scale=scale,
                                         block_row=torch.from_numpy(ROWS[slot]),
                                         **{k: torch.from_numpy(v) for k, v in args.items()},
                                         **tw)
        chunk = jax.jit(partial(JP.chunk_attend_paged, jrt, tier=0, first=offset == 0,
                                scale=scale))  # the engine's numerics: jitted
        j_out, j = chunk(j, slot=jnp.int32(slot), offset=jnp.int32(offset),
                         valid=jnp.int32(valid), block_row=jnp.asarray(ROWS[slot]),
                         **{k: jnp.asarray(v) for k, v in args.items()}, **jw)
        _close(t_out[:, :valid], np.asarray(j_out)[:, :valid])
        lengths[slot] = offset + valid
    pages = ROWS[ROWS > 0]
    active = np.array([True, True, False])
    for _ in range(3):
        ln = np.array(lengths, np.int32)
        q = f(SLOTS, 1, H, DN + R)
        args = dict(q=q, k_t=q[..., :KV, :], v_t=q[..., :KV, :], x_t=f(SLOTS, 1, DM),
                    k_rope_t=f(SLOTS, 1, KV, R), q_nope=q[..., R:], q_rope=q[..., :R])
        t_out, t = TP.decode_attend_paged(
            rt, t, TP.RowState(torch.from_numpy(ln), torch.from_numpy(ROWS),
                               torch.from_numpy(active), torch.zeros(SLOTS, dtype=torch.int32)),
            **{k: torch.from_numpy(v) for k, v in args.items()}, **tw, scale=scale)
        j_out, j = jax.jit(partial(JP.decode_attend_paged, jrt, scale=scale))(
            j, JP.RowState(jnp.asarray(ln), jnp.asarray(ROWS), jnp.asarray(active),
                                jnp.zeros(SLOTS, jnp.int32)),
            **{k: jnp.asarray(v) for k, v in args.items()}, **jw)
        _close(t_out[:2], np.asarray(j_out)[:2])
        lengths = [n + int(a) for n, a in zip(lengths, active)]
    for a, b in ((t.x.codes, j.x.codes), (t.x.level, j.x.level), (t.k_rope, j.k_rope)):
        np.testing.assert_array_equal(_np(a)[pages], _np(b)[pages])
    for a, b in ((t.x.scale, j.x.scale), (t.x.zero, j.x.zero), (t.x.num_levels, j.x.num_levels),
                 (t.x.prune_thr, j.x.prune_thr)):
        np.testing.assert_array_equal(_np(a)[:2], _np(b)[:2])


def test_pack_and_permute_match_jax():
    """One-shot admission packs a prefilled B=1 CPQ X cache into slot 1's
    pages; the defrag permutation moves the code, level and roped-key pages
    and leaves the slot tables."""
    rng = np.random.default_rng(6)
    S = 10
    x = rng.normal(size=(1, S, DM)).astype(np.float32)
    kr = rng.normal(size=(1, S, KV, R)).astype(np.float32)
    t_src = TK.CPQXCache(TC.cpq_compress_prefill(torch.from_numpy(x[:, :, None]), CPQCfg(), 12),
                         torch.from_numpy(np.pad(kr, ((0, 0), (0, 2), (0, 0), (0, 0)))),
                         TK.host_length(S))
    j_src = JK.CPQXCache(jax.jit(partial(JC.cpq_compress_prefill, cfg=JCPQCfg(), n_max=12))(
                             jnp.asarray(x[:, :, None])),
                         jnp.asarray(np.pad(kr, ((0, 0), (0, 2), (0, 0), (0, 0)))),
                         jnp.asarray(S, jnp.int32))
    t = TP.init_paged_cpq_x(P, PAGE, SLOTS, DM, KV, R, CPQCfg(), torch.float32)
    j = JP.init_paged_cpq_x(P, PAGE, SLOTS, DM, KV, R, JCPQCfg(), jnp.float32)
    row = np.array([5, 8, 2], np.int32)
    t = TP.pack_into("decomposed_cpq", t, t_src, torch.from_numpy(row), 1)
    j = JP.pack_into("decomposed_cpq", j, j_src, jnp.asarray(row), jnp.asarray(1, jnp.int32))
    _same((t.x.codes[1:], t.x.level[1:], t.k_rope[1:]), (j.x.codes[1:], j.x.level[1:],
                                                           j.k_rope[1:]))
    _same(tuple(t.x)[2:], tuple(j.x)[2:])
    perm = rng.permutation(P).astype(np.int32)
    TP.permute_pool(t, torch.from_numpy(perm))
    _same(t, JP.permute_pool(j, jnp.asarray(perm)))
    with pytest.raises(TypeError, match="copy-on-write"):
        TP.copy_page(t, 1, 2)


# ------------------------------------------------------------------ engines


@pytest.fixture(scope="module")
def qwen():
    return smoke_pair("qwen1.5-0.5b", num_blocks=2)


def _requests(vocab, cap=12):
    work = make_workload(0, 8, vocab, 0.5)
    return lambda ns: [ns.Request(rid=w.rid, prompt=w.prompt, max_new_tokens=min(w.target, cap),
                                  arrival=w.arrival) for w in work]


@pytest.mark.parametrize("chunk,fused", [(8, True), (8, False), (0, True)])
def test_engine_serves_as_jax(qwen, chunk, fused):
    """Chunked (``prefill_chunk=8``) and one-shot admission: greedy streams,
    tick stamps, ``stats()`` and events identical to the reference's paged
    engine, generations capped at 12 tokens as the CPQ tests cap them."""
    (_, jst), (_, tst) = serve_pair(
        qwen, _requests(qwen[0].vocab_size),
        dict(num_slots=3, page_size=4, num_pages=65, max_blocks_per_slot=32,
             prefill_chunk=chunk, prefill_bucket=8, use_paged_kernels=fused),
        gen=dict(max_new_tokens=12), rt=dict(mode="decomposed_cpq"))
    assert tst["cache_mode"] == "decomposed_cpq" and tst["chunked_prefill"] == bool(chunk)
    assert tst["bytes_per_token_layer"] == jst["bytes_per_token_layer"]


def test_static_engine_serves_as_jax(qwen):
    from repro.serving import engine as jeng

    cfg, tcfg, params, tparams = qwen
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, size=(3, 13)).astype(np.int32)
    out_j, st_j = jeng.ServeEngine(cfg, params, rt=jconfigs.AttentionRuntime(
        mode="decomposed_cpq")).generate({"tokens": jnp.asarray(toks)},
                                         jeng.GenerationConfig(max_new_tokens=10))
    out_t, st_t = T.ServeEngine(tcfg, tparams, rt=T.AttentionRuntime(mode="decomposed_cpq"),
                                device="cpu").generate({"tokens": toks},
                                                       T.GenerationConfig(max_new_tokens=10))
    np.testing.assert_array_equal(out_t, np.asarray(out_j))
    assert st_t == {k: v for k, v in st_j.items() if k in st_t}
