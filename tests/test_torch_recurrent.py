"""The port's recurrent mixers (``models/mamba.py``, ``models/xlstm.py``)
against the JAX package's, at float32 on the smoke widths of jamba and
xlstm-125m, with the same seeded weights and numpy inputs on both sides:
whole-sequence forwards (a T that is not a multiple of the chunk),
continuing a state (``forward(x)`` against ``forward(x1)`` then
``forward(x2, state)``) and decode chains. Stated tolerance: 5e-5 absolute
(the reference's own forms agree to 2e-5, ``tests/test_recurrent.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.common.param import init_tree
from repro.configs import ARCHS, smoke_config
from repro.models import mamba as jmamba
from repro.models import xlstm as jxlstm
import repro_torch as T
from repro_torch.models import mamba as tmamba
from repro_torch.models import transformer as tfm
from repro_torch.models import xlstm as txlstm
from repro_torch.params import init_params, layer_defs

TOL = 5e-5

# mixer: (arch, JAX module, port module, defs, forward, decode, init_state, T, split)
MIXERS = {
    "mamba": ("jamba-1.5-large-398b", jmamba, tmamba, "mamba_defs", "mamba_forward",
              "mamba_decode", "init_mamba_state", 150, 67),   # 2 chunks of 128, padded
    "mlstm": ("xlstm-125m", jxlstm, txlstm, "mlstm_defs", "mlstm_forward", "mlstm_decode",
              "init_mlstm_state", 40, 17),                   # 3 chunks of 16, padded
    "slstm": ("xlstm-125m", jxlstm, txlstm, "slstm_defs", "slstm_forward", "slstm_decode",
              "init_slstm_state", 21, 9),
}


def _setup(mixer, seed=0):
    arch, jm, tm, defs, fwd, dec, init, T_, split = MIXERS[mixer]
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype="float32")
    tcfg = dataclasses.replace(T.smoke_config(T.ARCHS[arch]), dtype="float32")
    jp = init_tree(getattr(jm, defs)(cfg), jax.random.PRNGKey(seed))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(seed).normal(size=(2, T_, cfg.d_model)).astype(np.float32)
    fns = {k: (getattr(jm, v), getattr(tm, v)) for k, v in
           (("fwd", fwd), ("dec", dec), ("init", init))}
    return cfg, tcfg, jp, tp, x, fns, split


def _close(t_tree, j_tree, what):
    for i, (t, j) in enumerate(zip(jax.tree.leaves(tuple(t_tree)), jax.tree.leaves(j_tree))):
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=TOL, rtol=0,
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("mixer", list(MIXERS))
def test_forward_matches_jax(mixer):
    cfg, tcfg, jp, tp, x, fns, _ = _setup(mixer)
    jy, jst = fns["fwd"][0](cfg, jp, jnp.asarray(x))
    ty, tst = fns["fwd"][1](tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=0)
    _close(tst, jst, f"{mixer} state")
    assert ty.abs().max() > 0.1   # the comparison is not of zeros


@pytest.mark.parametrize("mixer", list(MIXERS))
def test_state_continuation_matches_jax(mixer):
    """forward(x1) then forward(x2, state) against the JAX package's whole
    forward(x): the outputs and the final state."""
    cfg, tcfg, jp, tp, x, fns, split = _setup(mixer, seed=1)
    jy, jst = fns["fwd"][0](cfg, jp, jnp.asarray(x))
    t = torch.from_numpy(x)
    y1, st1 = fns["fwd"][1](tcfg, tp, t[:, :split])
    y2, st2 = fns["fwd"][1](tcfg, tp, t[:, split:], st1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), np.asarray(jy), atol=TOL,
                               rtol=0)
    _close(st2, jst, f"{mixer} state")


@pytest.mark.parametrize("mixer", list(MIXERS))
def test_decode_chain_matches_jax(mixer):
    """A prefill of the first tokens, then a decode step a token, on both
    sides: every step's output and the state after the chain."""
    cfg, tcfg, jp, tp, x, fns, split = _setup(mixer, seed=2)
    _, jst = fns["fwd"][0](cfg, jp, jnp.asarray(x[:, :split]))
    _, tst = fns["fwd"][1](tcfg, tp, torch.from_numpy(x[:, :split]))
    for t in range(split, split + 6):
        jy, jst = fns["dec"][0](cfg, jp, jnp.asarray(x[:, t:t + 1]), jst)
        ty, tst = fns["dec"][1](tcfg, tp, torch.from_numpy(x[:, t:t + 1]), tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=0,
                                   err_msg=f"{mixer} step {t}")
    _close(tst, jst, f"{mixer} state")


def test_mlstm_seq_ref_matches_jax_and_the_chunkwise_form():
    cfg, tcfg, jp, tp, x, _, _ = _setup("mlstm", seed=3)
    jy, jst = jxlstm.mlstm_seq_ref(cfg, jp, jnp.asarray(x))
    ty, tst = txlstm.mlstm_seq_ref(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=0)
    _close(tst, jst, "mlstm_seq_ref state")
    tc, _ = txlstm.mlstm_forward(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(tc.numpy(), ty.numpy(), atol=3e-4, rtol=0)  # the reference's


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m"])
def test_param_tree_matches_jax(arch):
    """``init_params`` gives every leaf of the JAX tree its shape and dtype
    (bf16 weights; the float32 leaves stay float32), Mamba's ``A_log`` its
    S4D values, and ``from_jax`` carries the block-stacked leaves across."""
    from repro.models import model as JM
    from repro_torch.params import from_jax

    cfg = smoke_config(ARCHS[arch])
    tcfg = T.smoke_config(T.ARCHS[arch])
    jtree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    carried = from_jax(jtree, device="cpu")
    ours = init_params(tcfg, 0, device="cpu")
    t_leaves = jax.tree.leaves(ours)
    assert len(t_leaves) == len(jax.tree.leaves(carried))
    for a, b in zip(t_leaves, jax.tree.leaves(carried)):
        assert a.shape == b.shape and a.dtype == b.dtype
    kinds = [k[0] for k in tcfg.block_pattern]
    first = ours["blocks"][0][0]["mixer"]
    f32 = {"mamba": ("conv_b", "dt_bias", "A_log", "D"), "mlstm": ("conv_b", "w_if", "b_if",
                                                                   "norm")}[kinds[0]]
    assert all(first[k].dtype == torch.float32 for k in f32)
    assert first[f32[0]].dtype != first["conv_w"].dtype == torch.bfloat16
    if kinds[0] == "mamba":
        want = carried["blocks"][0][0]["mixer"]["A_log"].numpy()   # log(1..d_state)
        np.testing.assert_allclose(first["A_log"].numpy(), want, rtol=1e-6, atol=0)
        assert (want == want[:1]).all() and want[0, 1] > want[0, 0] == 0
    else:
        sl = ours["blocks"][kinds.index("slstm")][0]["mixer"]
        assert sl["b"].dtype == sl["norm"].dtype == torch.float32
        assert sl["r"].shape == (4, tcfg.num_heads, 16, 16)


def test_only_the_xattn_mixer_is_refused():
    cfg = T.smoke_config(T.ARCHS["jamba-1.5-large-398b"])
    xcfg = T.smoke_config(T.ARCHS["xlstm-125m"])
    for c, kind in ((cfg, ("mamba", "moe")), (xcfg, ("mlstm", "none")),
                    (xcfg, ("slstm", "none"))):
        assert "mixer" in layer_defs(c, kind)
    with pytest.raises(NotImplementedError, match="A19: the xattn mixer"):
        layer_defs(cfg, ("xattn", "dense"))
    with pytest.raises(ValueError, match="one-shot"):   # no chunked recurrent prefill
        tfm.layer_prefill_chunk(cfg, cfg.attention, 0, True, ("mamba", "dense"), {}, None,
                                None, 0, None, 0, 1, None)
