"""The port's collective patterns and GPipe (``repro_torch.distributed``)
against the JAX package's, and the sharded paged arena against replicated
ones. The reference's ``flash_decoding_attention``, ``ring_decomposed_scores``
and ``gpipe_forward`` run in ONE subprocess with 8 emulated host devices,
under ``jax.set_mesh`` (the JAX version here wants the mesh entered; the
reference's own tests predate that), on the inputs and at the sizes of its
``tests/test_distributed.py``; the port runs the same inputs over shards
that share the CPU, within the reference test's bounds (1e-5, 2e-4, 1e-6).
The arena property replays fixed-seed alloc/write/retire/defrag histories
on a head-split arena (mp 2, 4, 8) and on replicated arenas of both
packages: the logical views are equal."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.serving import paged_cache as jpgc
from repro_torch.core import kv_cache as kvc
from repro_torch.distributed.collectives import (flash_decoding_attention,
                                                 ring_decomposed_scores, shard_along)
from repro_torch.distributed.pipeline import bubble_fraction, gpipe_forward
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.serving import paged_cache as pgc
from repro_torch.serving.sharded import shard_container

from conftest import run_with_devices


def inputs() -> dict:
    """The reference test's sizes, drawn with numpy from one seed."""
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    B, H, KV, Dh, N = 2, 8, 4, 32, 128
    return dict(q=f(B, 1, H, Dh), k=f(B, N, KV, Dh), v=f(B, N, KV, Dh), r=f(B, 16, 64),
                x=f(B, N, 64), w=f(8, 16, 16) / 4.0, xm=f(6, 2, 16), gx=f(8, 128))


REFERENCE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.distributed.collectives import flash_decoding_attention, ring_decomposed_scores
from repro.distributed.pipeline import gpipe_forward
a = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((8,), ('s',))
with jax.set_mesh(mesh):
    fd = flash_decoding_attention(mesh, 's')(a['q'], a['k'], a['v'],
                                             jnp.asarray(100, jnp.int32), 0.125)
    ring = ring_decomposed_scores(mesh, 's')(a['r'], a['x'])
pmesh = jax.make_mesh((4,), ('pod',))
with jax.set_mesh(pmesh):
    gp = gpipe_forward(pmesh, 'pod', lambda p, h: jnp.tanh(h @ p))(a['w'], a['xm'])
# compressed_psum: the reference test's 20 steps, on Auto axes (under the
# Explicit axes jax.make_mesh makes by default, its shard_map raises)
from jax.sharding import AxisType, PartitionSpec as P
from repro.optim.compression import compressed_psum
cmesh = jax.make_mesh((8,), ('pod',), axis_types=(AxisType.Auto,))
def body(xl, err):
    m, e = compressed_psum(xl[0], err[0], 'pod')
    return m[None], e[None]
f = jax.shard_map(body, mesh=cmesh, in_specs=(P('pod'), P('pod')), out_specs=(P('pod'), P('pod')))
x = jnp.asarray(a['gx'])
err = jnp.zeros_like(x)
means, errs = [], []
for step in range(20):
    m, err = f(x, err)
    means.append(np.asarray(m))
    errs.append(np.asarray(err))
np.savez(sys.argv[2], fd=np.asarray(fd), ring=np.asarray(ring), gp=np.asarray(gp),
         psum_mean=np.stack(means), psum_err=np.stack(errs))
print('REFERENCE-OK')
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    a = inputs()
    np.savez(d / "in.npz", **a)
    code = REFERENCE.replace("sys.argv[1]", repr(str(d / "in.npz"))).replace(
        "sys.argv[2]", repr(str(d / "out.npz")))
    assert "REFERENCE-OK" in run_with_devices(code)
    return a, dict(np.load(os.path.join(d, "out.npz")))


def _line(n: int, name: str) -> Mesh:
    return Mesh(np.array([torch.device("cpu")] * n, dtype=object), (name,))


def test_flash_decoding_matches_the_reference(reference):
    a, ref = reference
    mesh = _line(8, "s")
    t = {k: torch.tensor(v) for k, v in a.items()}
    devs = mesh.axis_devices("s")
    out = flash_decoding_attention(mesh, "s")(t["q"], shard_along(t["k"], 1, devs),
                                              shard_along(t["v"], 1, devs), 100, 0.125)
    assert out.shape == ref["fd"].shape
    assert np.abs(out.numpy() - ref["fd"]).max() < 1e-5
    # ... and the attention it stands for, on one device
    s = torch.einsum("bhd,bnhd->bhn", t["q"][:, 0], t["k"].repeat_interleave(2, dim=2)) * 0.125
    s[..., 100:] = -1e30
    dense = torch.einsum("bhn,bnhd->bhd", torch.softmax(s, -1),
                         t["v"].repeat_interleave(2, dim=2))[:, None]
    assert (out - dense).abs().max() < 1e-5


def test_ring_scores_match_the_reference(reference):
    a, ref = reference
    mesh = _line(8, "s")
    devs = mesh.axis_devices("s")
    r, x = torch.tensor(a["r"]), torch.tensor(a["x"])
    parts = ring_decomposed_scores(mesh, "s")(shard_along(r, 1, devs), shard_along(x, 1, devs))
    got = torch.cat(parts, dim=1).numpy()
    assert got.shape == ref["ring"].shape
    assert np.abs(got - ref["ring"]).max() < 2e-4
    assert np.abs(got - np.einsum("bhm,bnm->bhn", a["r"], a["x"])).max() < 2e-4


def test_gpipe_matches_the_reference(reference):
    a, ref = reference
    w, xm = torch.tensor(a["w"]), torch.tensor(a["xm"])
    out = gpipe_forward(_line(4, "pod"), "pod", lambda p, h: torch.tanh(h @ p))(w, xm)
    assert np.abs(out.numpy() - ref["gp"]).max() < 1e-6
    seq = xm
    for i in range(8):
        seq = torch.tanh(seq @ w[i])
    assert (out - seq).abs().max() < 1e-6
    # a tree of stacked parameters, as a model's blocks are
    tree = gpipe_forward(_line(2, "pod"), "pod",
                         lambda p, h: torch.tanh(h @ p["w"]) * p["g"])(
        {"w": w, "g": torch.full((8, 1), 0.5)}, xm)
    seq = xm
    for i in range(8):
        seq = torch.tanh(seq @ w[i]) * 0.5
    assert (tree - seq).abs().max() < 1e-6


def test_bubble_fraction_matches_the_reference():
    from repro.distributed.pipeline import bubble_fraction as ref

    for m in (1, 2, 6, 32):
        for s in (1, 2, 4, 8):
            assert bubble_fraction(m, s) == ref(m, s)
    assert bubble_fraction(1, 4) == 0.75 and bubble_fraction(32, 2) < 0.04


def _scenario(seed: int, num_pages: int, n_slots: int, mp: int) -> None:
    """One history (the reference's ``_ARENA_PROPERTY_CODE`` scenario) on a
    sharded port arena, a replicated port arena and a replicated JAX arena."""
    page, kv, dh, max_blocks = 2, 8, 4, 4
    rng = np.random.default_rng(seed)
    meta = pgc.init_paged_dense(num_pages, page, kv, dh, torch.float32, "meta")
    probe = pgc.init_paged_dense(2, page, kv, dh, torch.float32, "cpu")
    shd = shard_container(meta, make_serve_mesh(1, mp, devices="cpu"), probe)
    ref = pgc.init_paged_dense(num_pages, page, kv, dh, torch.float32, "cpu")
    jref = jnp.zeros((num_pages, page, kv, dh), jnp.float32)
    alloc = pgc.PageAllocator(num_pages)
    tables = np.zeros((n_slots, max_blocks), np.int32)
    owned = {}
    for _ in range(20):
        op = rng.integers(0, 3)
        if op == 0:  # admit a prompt into a free slot
            slot = next((s for s in range(n_slots) if s not in owned), None)
            n_tok = int(rng.integers(1, page * max_blocks + 1))
            need = pgc.pages_needed(n_tok, page)
            if slot is None or not alloc.can_alloc(need):
                continue
            pages = alloc.alloc(need)
            owned[slot] = pages
            tables[slot, :] = pgc.NULL_PAGE
            tables[slot, :need] = pages
            val = rng.normal(size=(n_tok, kv, dh)).astype(np.float32)
            row = torch.tensor(tables[slot])
            src = kvc.DenseKVCache(torch.tensor(val)[None], -torch.tensor(val)[None],
                                   kvc.host_length(n_tok))
            pgc.pack_into("dense", shd, src, row, slot)
            pgc.pack_into("dense", ref, src, row, slot)
            jref = jpgc.write_prompt_pages(jref, jnp.asarray(tables[slot]), jnp.asarray(val))
        elif op == 1:  # retire a slot
            if not owned:
                continue
            slot = int(rng.choice(list(owned)))
            alloc.free(owned.pop(slot))
            tables[slot, :] = pgc.NULL_PAGE
        else:  # defrag: relabel mapped pages onto the lowest ids
            perm, new_bt, free = pgc.defrag_plan(tables, num_pages)
            remap = {int(o): n for n, o in enumerate(perm)}
            tables[:] = new_bt
            owned = {s: [remap[p] for p in ps] for s, ps in owned.items()}
            alloc.relabel(perm, free)
            pgc.permute_pool(shd, torch.tensor(perm))
            pgc.permute_pool(ref, torch.tensor(perm))
            jref = jnp.take(jref, jnp.asarray(perm), axis=0)
    bt = torch.tensor(tables)
    whole = pgc.assemble(shd)
    for got, want in ((whole.k, ref.k), (whole.v, ref.v)):
        np.testing.assert_array_equal(pgc.gather_pages(got, bt).numpy(),
                                      pgc.gather_pages(want, bt).numpy())
    np.testing.assert_array_equal(pgc.gather_pages(whole.k, bt).numpy(),
                                  np.asarray(jpgc.gather_pages(jref, jnp.asarray(tables))))
    assert all(s.k.shape[2] == kv // mp for s in shd.shards)


@pytest.mark.parametrize("mp", [2, 4, 8])
def test_sharded_arena_history_keeps_the_logical_views(mp):
    for seed in range(8):
        _scenario(seed, 4 + 3 * seed, 1 + seed % 4, mp)


def _codes(xf: np.ndarray, new_err: np.ndarray) -> np.ndarray:
    """The int8 codes a compressed_psum step sent, from its inputs plus
    error (xf) and the error it kept: xf - codes * scale == new_err, with
    the scale the shards share."""
    scale = max(np.float32(np.abs(xf).max()) / np.float32(127.0), np.float32(1e-12))
    return np.round((xf - new_err) / scale).astype(np.int64)


def test_compressed_psum_matches_the_reference(reference):
    """The reference test's 20 error-feedback steps over 8 shards (row i is
    shard i's gradient): the codes identical, each step's mean and error
    buffers within 1e-6, and the reference's drift bound met."""
    from repro_torch.optim.compression import compressed_psum

    a, ref = reference
    x = torch.tensor(a["gx"])
    mesh = _line(8, "pod")
    xs = shard_along(x, 0, mesh.axis_devices("pod"))
    errs = [torch.zeros_like(t) for t in xs]
    acc = torch.zeros(128)
    true_mean = x.mean(0)
    for step in range(20):
        xf = torch.cat([t + e for t, e in zip(xs, errs)]).numpy()
        ref_xf = a["gx"] + (ref["psum_err"][step - 1] if step else 0.0)
        means, errs = compressed_psum(xs, errs)
        got_err = torch.cat(errs).numpy()
        np.testing.assert_array_equal(_codes(xf, got_err),
                                      _codes(ref_xf, ref["psum_err"][step]))
        for m in means:
            assert np.abs(m[0].numpy() - ref["psum_mean"][step][0]).max() <= 1e-6
        assert np.abs(got_err - ref["psum_err"][step]).max() <= 1e-6
        acc = acc + means[0][0]
    drift = float((acc / 20 - true_mean).abs().max())
    one = float((means[0][0] - true_mean).abs().max())
    assert drift < one * 0.5 + 1e-5, (drift, one)
