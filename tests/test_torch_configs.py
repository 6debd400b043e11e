"""The port's config dataclasses against the JAX package's, field for field:
every registered architecture, its smoke reduction, the serving and runtime
defaults, and the ``ServingCfg.validate`` errors."""
import dataclasses

import pytest
import torch

from repro import configs as jc
import repro_torch.configs as tc

ARCH_NAMES = sorted(jc.ARCHS)


def test_registry_names_and_order():
    assert list(tc.ARCHS) == list(jc.ARCHS)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_arch_field_for_field(name):
    assert dataclasses.asdict(tc.ARCHS[name]) == dataclasses.asdict(jc.ARCHS[name])
    assert (tc.ARCHS[name].num_layers, tc.ARCHS[name].layer_kinds) == \
        (jc.ARCHS[name].num_layers, jc.ARCHS[name].layer_kinds)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_smoke_config_field_for_field(name):
    t, j = tc.smoke_config(tc.ARCHS[name]), jc.smoke_config(jc.ARCHS[name])
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_param_dtype_is_torch():
    cfg = tc.ARCHS["qwen1.5-0.5b"]
    assert cfg.param_dtype is torch.bfloat16
    assert dataclasses.replace(cfg, dtype="float32").param_dtype is torch.float32


def test_serving_and_runtime_defaults():
    assert dataclasses.asdict(tc.ServingCfg()) == dataclasses.asdict(jc.ServingCfg())
    assert tc.ServingCfg().max_len == jc.ServingCfg().max_len
    for mode in ("dense", "decomposed", "cpq", "retrieval", "decomposed_cpq"):
        assert (dataclasses.asdict(tc.AttentionRuntime(mode=mode))
                == dataclasses.asdict(jc.AttentionRuntime(mode=mode)))


@pytest.mark.parametrize("kw,strict", [
    (dict(num_pages=1), False),
    (dict(page_size=0), False),
    (dict(critical_watermark=0.5, low_watermark=0.25), False),
    (dict(high_watermark=0.1), False),
    (dict(policy="lifo"), False),
    (dict(prefill_bucket=0), False),
    (dict(prefill_chunk=-1), False),
    (dict(prefill_chunk=12, page_size=8), False),
    (dict(defrag_every=-1), False),
    (dict(probe_failures=0), False),
    (dict(deadline_scale=-1.0), False),
    (dict(spec_len=2, prefill_chunk=0), True),
    (dict(page_size=1, max_blocks_per_slot=1, prefill_chunk=0), True),
])
def test_validate_errors_match(kw, strict):
    def err(mod):
        try:
            if strict:
                mod.ServingCfg(**kw).validate()
            else:
                mod.ServingCfg(**kw)
        except ValueError as e:
            return str(e)
        return None

    msg = err(jc)
    assert msg is not None and err(tc) == msg
