"""Checkpoints cross between the port and the JAX package, and the port's
train entry point trains and resumes as the reference's does.

A checkpoint the port writes (zlib leaves, its own msgpack coder, bf16 as
a uint16 bit view) is restored by ``repro.checkpoint.CheckpointManager``
into the JAX trees (parameters and ``AdamWState``), and one the JAX
package writes (zstd leaves where ``zstandard`` is installed) by the
port's: every array equal, bit for bit. The port's meta file holds the
bytes ``msgpack.packb`` gives for the same meta. ``launch.train.main`` at
``--device cpu``: the reference's ``test_training_reduces_loss`` and
``test_training_resume_bit_exact`` on the port (rtol 1e-5)."""
import dataclasses
import json
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import ARCHS, smoke_config
from repro.optim import adamw as j_adamw
import repro_torch.configs as tc
from repro_torch.checkpoint import CheckpointManager, split_train_state, train_state
from repro_torch.checkpoint import msgpack_lite
from repro_torch.optim import adamw
from repro_torch.params import ref_leaves, stack_blocks
from torch_train_cases import jax_params, to_torch


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind not in "biu" else a


def _port_bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    a = t.numpy()
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind not in "biu" else a


def _trees(arch: str):
    """bf16 JAX weights (gates at 0.5) and an AdamW state after one step,
    in both packages."""
    jcfg = dataclasses.replace(smoke_config(ARCHS[arch]), num_blocks=2)
    jp = jax_params(jcfg)
    jopt = j_adamw(1e-3)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32), jp)
    _, js = jopt.update(grads, jopt.init(jp), jp, jnp.asarray(0, jnp.int32))
    tp = to_torch(jp)
    ts = type(adamw(1e-3).init(tp))(*(jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), f) for f in js))
    return jp, js, tp, ts


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama-3.2-vision-11b"])
def test_port_checkpoint_restores_in_jax(arch):
    jp, js, tp, ts = _trees(arch)
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save(3, train_state(tp, ts))
        got = JCheckpointManager(d).restore(3, {"params": jp, "opt": js})
        meta = (Path(d) / "step_3" / "meta.msgpack").read_bytes()
    want = jax.tree.leaves({"params": jp, "opt": js})
    leaves = jax.tree.leaves(got)
    assert len(leaves) == len(want)
    assert any(np.asarray(w).dtype.name == "bfloat16" for w in want)
    for g, w in zip(leaves, want):
        assert g.shape == w.shape and np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # the meta is msgpack's own encoding of the same dict
    assert msgpack.packb(msgpack.unpackb(meta)) == meta
    assert msgpack_lite.unpackb(meta) == msgpack.unpackb(meta)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama-3.2-vision-11b"])
def test_jax_checkpoint_restores_in_the_port(arch):
    jp, js, tp, ts = _trees(arch)
    with tempfile.TemporaryDirectory() as d:
        JCheckpointManager(d).save(5, {"params": jp, "opt": js})
        mgr = CheckpointManager(d)
        got = mgr.restore(5, train_state(tp, ts))
        assert mgr.meta(5)["num_leaves"] == len(ref_leaves(got))
    want = jax.tree.leaves({"params": jp, "opt": js})
    leaves = ref_leaves(got)
    assert len(leaves) == len(want)
    for g, w in zip(leaves, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(_port_bits(g), _bits(w))
    params, _ = split_train_state(got)  # back in the port's layout
    assert torch.equal(params["blocks"][0][1]["norm1"]["scale"],
                       tp["blocks"][0][1]["norm1"]["scale"])


def test_msgpack_subset_matches_msgpack():
    meta = {"step": 300, "treedef": "{'opt': AdamWState(*, *)}", "num_leaves": 70000,
            "shapes": [[2, 64], [], [151936, 1024], [2 ** 33]], "dtypes": ["bfloat16"] * 40,
            "extra": {"note": "x" * 300, "neg": [-1, -33, -200, -40000, -2 ** 40],
                      "big": 2 ** 63, "none": None}}
    for obj in (meta, "s" * 31, "s" * 32, "s" * 70000, list(range(16)),
                {str(i): i for i in range(16)}):
        assert msgpack_lite.packb(obj) == msgpack.packb(obj)
        assert msgpack_lite.unpackb(msgpack.packb(obj)) == msgpack.unpackb(msgpack.packb(obj))


def test_save_async_snapshots_before_the_write():
    cfg = tc.smoke_config(tc.ARCHS["qwen1.5-0.5b"])
    from repro_torch.params import init_params

    params = init_params(cfg, 0, device="cpu")
    tree = {"params": stack_blocks(params)}
    want = [t.clone() for t in ref_leaves(tree)]
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        mgr.save_async(1, tree)
        for t in ref_leaves(tree):  # training mutates the buffers meanwhile
            t.zero_()
        mgr.save(2, tree)
        mgr.save(3, tree)
        mgr.close()
        assert mgr.all_steps() == [2, 3]  # keep=2: the oldest went
        mgr = CheckpointManager(d)
        assert mgr.latest_step() == 3
        (tmp := Path(d) / "step_9").mkdir()  # no COMMIT: ignored
        assert mgr.latest_step() == 3 and tmp.exists()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        tree = {"params": stack_blocks(init_params(cfg, 0, device="cpu"))}
        mgr.save_async(1, tree)
        for t in ref_leaves(tree):
            t.zero_()
        mgr.close()
        got = mgr.restore(1, tree)
    for g, w in zip(ref_leaves(got), want):
        assert torch.equal(g, w)


def test_port_training_reduces_loss():
    from repro_torch.launch.train import main

    with tempfile.TemporaryDirectory() as d:
        loss = main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "60", "--batch", "8",
                     "--seq", "64", "--lr", "3e-3", "--log-every", "30", "--ckpt-dir", d,
                     "--device", "cpu"])
        lines = (Path(d) / "metrics.jsonl").read_text().splitlines()
    assert loss < 5.2, loss  # ln(256) = 5.55 at the start; the structure is learnable
    assert [json.loads(x)["step"] for x in lines] == [1, 30, 60]


def test_port_training_resumes_as_a_straight_run():
    """Stop at 20, resume to 30 == a straight run to 30."""
    from repro_torch.launch.train import main

    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        args = ["--arch", "qwen1.5-0.5b", "--smoke", "--batch", "4", "--seq", "32",
                "--lr", "1e-3", "--log-every", "100", "--device", "cpu"]
        main(args + ["--steps", "20", "--ckpt-dir", d1, "--ckpt-every", "100"])
        l_resumed = main(args + ["--steps", "30", "--ckpt-dir", d1, "--ckpt-every", "100"])
        l_straight = main(args + ["--steps", "30", "--ckpt-dir", d2, "--ckpt-every", "100"])
    np.testing.assert_allclose(l_resumed, l_straight, rtol=1e-5)
