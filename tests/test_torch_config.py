"""herald_tpu_torch.config against herald_tpu.config: a `--save-config`
JSON written by either package loads in the other, bf16 table included."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herald_tpu.config import HeraldConfig as JaxConfig
from herald_tpu_torch.config import HeraldConfig

CASES = [
    dict(model="wdl_criteo", batch_size=16, embedding_dim=8,
         table_dtype="bfloat16"),
    dict(model="wdl_avazu", batch_size=256, embedding_dim=128,
         table_dtype="float32", optimizer="adagrad", comm_mode="hybrid",
         mesh_shape=[4], flush_wire_dtype="bfloat16", use_cache=True,
         use_scheduler=True, cache_limit_ratio=0.2),
]
_JAX_DT = {"float32": np.float32, "bfloat16": jnp.bfloat16}
_TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _make(kw, dts):
    kw = dict(kw)
    for k in ("table_dtype", "flush_wire_dtype"):
        if k in kw:
            kw[k] = dts[kw[k]]
    return kw


def test_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(HeraldConfig)}
    assert set(tf) - set(jf) == {"device"}
    assert set(jf) <= set(tf)
    for k in jf:
        if k in ("dtype", "table_dtype"):
            continue
        assert tf[k] == jf[k], k


@pytest.mark.parametrize("kw", CASES, ids=["bf16_local", "f32_hybrid"])
def test_json_round_trips_both_ways(kw):
    jcfg = JaxConfig(**_make(kw, _JAX_DT))
    tcfg = HeraldConfig(**_make(kw, _TORCH_DT))
    # JAX -> port
    from_jax = HeraldConfig.from_json(jcfg.to_json())
    assert from_jax == tcfg
    assert from_jax.table_dtype == _TORCH_DT[kw["table_dtype"]]
    # port -> JAX: the JAX loader reads the port's file into the config
    # that wrote the same JSON
    from_port = JaxConfig.from_json(tcfg.to_json())
    assert json.loads(from_port.to_json()) == json.loads(jcfg.to_json())
    assert np.dtype(from_port.table_dtype) == np.dtype(jcfg.table_dtype)
    # the two files are the same JSON
    assert json.loads(tcfg.to_json()) == json.loads(jcfg.to_json())
    # port -> port
    assert HeraldConfig.from_json(tcfg.to_json()) == tcfg


def test_device_is_a_runtime_field():
    cfg = HeraldConfig(device="cpu")
    assert "device" not in json.loads(cfg.to_json())
    assert HeraldConfig.from_json(cfg.to_json()).device is None
    with pytest.raises(ValueError, match="unsupported dtype"):
        HeraldConfig.from_json(json.dumps(
            {**json.loads(cfg.to_json()), "table_dtype": "int8"}))
