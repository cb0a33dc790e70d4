"""The port's ToMP and TaMOs-SwinBase parameter modules against the JAX
package's: `ToMPParams` has the JAX dataclass's fields and defaults, and
each module builds its net with the JAX module's arguments under the JAX
precision switches (PYTRACKING_TPU_BF16, PYTRACKING_TPU_BF16_BACKBONE),
mapped to the port's `dtype` / `backbone_dtype` arguments.

The JAX modules run with their net constructors, `env_settings` and
`load_or_init_variables` replaced on the module objects by stubs, so no
net is initialised and nothing is written; the port's net constructors
are stubbed the same way.
"""

import dataclasses
import importlib
import types

import jax.numpy as jnp
import pytest
import torch
from torch import nn

from pytracking_tpu_torch.models.layers.blocks import BatchNorm
from pytracking_tpu_torch.trackers import tomp as t_tomp

# parameter module: (package, net constructor)
MODULES = {"tomp50": ("tomp", "tompnet50"), "tomp101": ("tomp", "tompnet101"),
           "tamos_swin_base": ("tamos", "tamosnet_swin_base")}
# JAX environment -> the port's arguments
PRECISIONS = {
    "f32": ({}, {}),
    "bf16_backbone": ({"PYTRACKING_TPU_BF16_BACKBONE": "1"},
                      {"backbone_dtype": torch.bfloat16}),
    "bf16": ({"PYTRACKING_TPU_BF16": "1"}, {"dtype": torch.bfloat16}),
}
_DTYPES = {None: None, jnp.bfloat16: torch.bfloat16}


def test_params_dataclass_matches_jax():
    from pytracking_tpu.trackers.tomp import ToMPParams

    ref = {f.name: f for f in dataclasses.fields(ToMPParams)}
    got = {f.name: f for f in dataclasses.fields(t_tomp.ToMPParams)}
    assert list(got) == list(ref)
    assert ToMPParams() == ToMPParams(**dataclasses.asdict(t_tomp.ToMPParams()))
    assert t_tomp.ToMPParams().image_sample_size == ToMPParams().image_sample_size == 288


def _stub_net():
    """A net whose weights bf16 cannot hold exactly, and a BatchNorm."""
    net = nn.Sequential(nn.Linear(3, 3), BatchNorm(3))
    with torch.no_grad():
        for p in net.parameters():
            p.fill_(1.0 + 2.0 ** -12)
    return net


# the JAX TaMOs-SwinBase module reads no backbone switch (its Swin is float32)
CASES = [(name, precision) for name in MODULES for precision in PRECISIONS
         if not (name == "tamos_swin_base" and precision == "bf16_backbone")]


@pytest.mark.parametrize("name,precision", CASES)
def test_parameter_module_matches_jax(name, precision, monkeypatch, tmp_path):
    package, constructor = MODULES[name]
    env_vars, port_kw = PRECISIONS[precision]
    for var in ("PYTRACKING_TPU_BF16", "PYTRACKING_TPU_BF16_BACKBONE"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env_vars.items():
        monkeypatch.setenv(var, value)

    jax_mod = importlib.import_module(f"pytracking_tpu.parameter.{package}.{name}")
    jax_built = {}
    monkeypatch.setattr(jax_mod, constructor,
                        lambda **kw: jax_built.setdefault("kw", kw) and constructor)
    env = types.SimpleNamespace(network_path=str(tmp_path / "absent"))
    monkeypatch.setattr(jax_mod, "env_settings", lambda: env)
    monkeypatch.setattr(jax_mod, "load_or_init_variables", lambda *a, **k: {})
    ref = jax_mod.parameters()
    assert not (tmp_path / "absent").exists()

    port_mod = importlib.import_module(f"pytracking_tpu_torch.parameter.{package}.{name}")
    built = {}

    def port_constructor(**kw):
        built["kw"] = kw
        built["net"] = _stub_net()
        return built["net"]

    monkeypatch.setattr(port_mod, constructor, port_constructor)
    got = port_mod.parameters(device="cpu", seed=3, **port_kw)
    # every field the port reads has the JAX module's value (the port's
    # TaMOsParams leaves out two fields the JAX tracker never reads)
    for f in dataclasses.fields(got.params):
        assert getattr(got.params, f.name) == getattr(ref.params, f.name), f.name
    assert got.net is built["net"]

    jkw, kw = jax_built["kw"], built["kw"]
    assert kw["generator"].initial_seed() == 3 and kw["device"] == "cpu"
    assert kw["feature_sz"] == jkw["feature_sz"]
    for key in ("backbone_dtype", "transformer_dtype", "num_tokens"):
        assert kw.get(key) == _DTYPES.get(jkw.get(key), jkw.get(key)), key

    # PYTRACKING_TPU_BF16 stores every weight as bf16 in ToMP (not in
    # TaMOs-SwinBase): the port rounds them through bf16
    weight = got.net[0].weight
    rounded = package == "tomp" and precision == "bf16"
    assert bool((weight == 1.0).all()) == rounded
    assert got.net[1].param_dtype == (torch.bfloat16 if rounded else torch.float32)
