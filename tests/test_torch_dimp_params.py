"""The port's DiMP parameter modules against the JAX package's: `DiMPParams`
has the JAX dataclass's fields and defaults, and each parameter module's
params equal the JAX module's `parameters().params`, field by field.

The JAX modules run with their net constructors, `env_settings` and
`load_or_init_variables` replaced on the module objects by stubs, so no
net is initialised and nothing is written.
"""

import dataclasses
import importlib
import types

import pytest

from pytracking_tpu_torch.trackers import dimp as t_dimp

MODULES = {  # parameter module: port package
    "dimp50": "dimp", "dimp18": "dimp", "prdimp18": "dimp", "prdimp50": "dimp",
    "super_dimp": "dimp", "dimp50_vot18": "dimp", "dimp50_vot19": "dimp",
    "dimp18_vot18": "dimp", "prdimp50_vot18": "dimp", "super_dimp_simple": "dimp_simple",
}
# the port net each module builds
NETS = {"dimp50": "dimpnet50", "dimp18": "dimpnet18", "prdimp18": "klcedimpnet18",
        "prdimp50": "klcedimpnet50", "super_dimp": "dimpnet50", "dimp50_vot18": "dimpnet50",
        "dimp50_vot19": "dimpnet50", "dimp18_vot18": "dimpnet18",
        "prdimp50_vot18": "klcedimpnet50", "super_dimp_simple": "dimpnet50_simple"}
_NET_CONSTRUCTORS = ("dimpnet50", "dimpnet18", "klcedimpnet50", "klcedimpnet18",
                     "dimpnet50_simple")


def test_params_dataclass_matches_jax():
    from pytracking_tpu.trackers.dimp import DiMPParams

    ref = {f.name: f for f in dataclasses.fields(DiMPParams)}
    got = {f.name: f for f in dataclasses.fields(t_dimp.DiMPParams)}
    assert list(got) == list(ref)
    assert DiMPParams() == DiMPParams(**dataclasses.asdict(t_dimp.DiMPParams()))
    assert t_dimp.DiMPParams(use_augmentation=False).aug_dict() == {}
    assert t_dimp.DiMPParams().aug_dict() == DiMPParams().aug_dict()


@pytest.fixture
def jax_params(monkeypatch, tmp_path):
    """name -> the JAX module's `parameters().params`, nets and variables stubbed."""
    env = types.SimpleNamespace(network_path=str(tmp_path / "absent"))
    for name in MODULES:
        pkg = "dimp_simple" if name == "super_dimp_simple" else "dimp"
        mod = importlib.import_module(f"pytracking_tpu.parameter.{pkg}.{name}")
        for attr in _NET_CONSTRUCTORS:
            if hasattr(mod, attr):
                monkeypatch.setattr(mod, attr, lambda *a, _n=attr, **k: _n)
        if hasattr(mod, "env_settings"):
            monkeypatch.setattr(mod, "env_settings", lambda: env)
        if hasattr(mod, "load_or_init_variables"):
            monkeypatch.setattr(mod, "load_or_init_variables", lambda *a, **k: {})

    def get(name):
        pkg = "dimp_simple" if name == "super_dimp_simple" else "dimp"
        spec = importlib.import_module(f"pytracking_tpu.parameter.{pkg}.{name}").parameters()
        return spec

    assert not (tmp_path / "absent").exists()
    return get


@pytest.mark.parametrize("name", list(MODULES))
def test_parameter_module_matches_jax(name, jax_params, monkeypatch):
    spec = jax_params(name)
    assert spec.net == NETS[name]                      # the JAX module's net
    port = importlib.import_module(f"pytracking_tpu_torch.parameter.{MODULES[name]}.{name}")
    built = {}
    # the module and the parameter modules it builds its net through
    # (the VOT sets build DiMP-50's with `dimp50.build_net`)
    for mod in (port, *(v for v in vars(port).values() if isinstance(v, types.ModuleType)
                        and v.__name__.startswith("pytracking_tpu_torch.parameter."))):
        for attr in _NET_CONSTRUCTORS:
            if hasattr(mod, attr):
                monkeypatch.setattr(mod, attr,
                                    lambda *a, _n=attr, **k: built.setdefault("net", (_n, k)))
    got = port.parameters(device="cpu", seed=3)
    ref = spec.params
    for f in dataclasses.fields(ref):
        assert getattr(got.params, f.name) == getattr(ref, f.name), f.name
    assert got.params == t_dimp.DiMPParams(**dataclasses.asdict(ref))
    net_name, kw = built["net"]
    assert net_name == NETS[name] and kw["device"] == "cpu"
    assert kw["generator"].initial_seed() == 3
