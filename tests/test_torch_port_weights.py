"""Loading trained networks into the port: upstream `.pth.tar` ingest
(`utils/port_weights.py`, `utils/loading.py`, `ingest_checkpoint.py`) and
the parameter modules' network files.

No published upstream checkpoint is in the repository. Upstream-format
state_dicts are written from the port's nets by
scripts/checkpoint_check.py, and held two ways against the net they came
from, bit for bit: through the JAX package's `port_*` (every key consumed)
and `utils/convert_weights.*_from_flax`, and through the port's loader.
So the writer is held to the JAX porters, and the port's loader to both.
Only keys and shapes come from the nets, which are built on the meta
device with their initialisers stubbed; the values are drawn with numpy.
The parameter modules are held with their net constructors replaced by a
tiny net: a file loads, a missing one gives the seeded net, a broken one
raises.
"""

import functools
import importlib
import importlib.util
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from torch import nn

from pytracking_tpu.utils import port_weights as jpw
from pytracking_tpu_torch import ingest_checkpoint as ingest_mod
from pytracking_tpu_torch.evaluation import environment
from pytracking_tpu_torch.models.layers.blocks import BatchNorm
from pytracking_tpu_torch.utils import convert_weights as cw
from pytracking_tpu_torch.utils import port_weights as pw
from pytracking_tpu_torch.utils.device import resolve_device
from pytracking_tpu_torch.utils.loading import (load_network, read_upstream_checkpoint,
                                                round_to_bf16_, save_network)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_{name}", os.path.join(REPO, "scripts",
                                                                          f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


writer = _script("checkpoint_check")
jax_ingest = _script("ingest_checkpoint")          # the JAX package's command

_M = "pytracking_tpu_torch.models"
INIT_MODULES = ("tracking.dimpnet", "tracking.atomnet", "tracking.kysnet", "tracking.tompnet",
                "tracking.tamosnet", "lwl.lwl_net", "lwl.sta_net", "rts.rts_net",
                "tcm.target_candidate_matching")


@pytest.fixture(autouse=True)
def one_thread():
    """PyTorch on one CPU thread for each test (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def meta_nets(monkeypatch):
    """Builds nets on the meta device with every model module's
    initialiser stubbed: keys and shapes only, in milliseconds."""
    for mod in INIT_MODULES:
        monkeypatch.setattr(importlib.import_module(f"{_M}.{mod}"), "init_weights",
                            lambda net, generator: net)

    def build(ctor, **kwargs):
        with torch.device("meta"):
            return ctor(**kwargs)
    return build


def _registry_net(family):
    _, _, module, name, kwargs, _ = ingest_mod.REGISTRY[family]
    ctor = getattr(importlib.import_module(module), name)
    return functools.partial(ctor, **kwargs, device="meta")


def _backbone(module, name, layers):
    return lambda: getattr(importlib.import_module(f"{_M}.backbones.{module}"), name)(layers)


# family: (the port's net, the JAX porter, the port's flax converter, the port's porter)
FAMILIES = {
    **{fam: (_registry_net(fam), entry[0], None, ingest_mod.REGISTRY[fam][0])
       for fam, entry in jax_ingest.REGISTRY.items()},
    "resnet18_vggm": (_backbone("vggm_resnet", "resnet18_vggmconv1", ("vggconv1", "layer4")),
                      jpw.port_resnet18_vggm, cw.resnet18_vggm_from_flax,
                      pw.port_resnet18_vggm),
    "mobilenetv3": (_backbone("mobilenetv3", "mobilenet3", ("init_conv", "layer_out")),
                    jpw.port_mobilenetv3, cw.mobilenet3_from_flax, pw.port_mobilenetv3),
}
CONVERTERS = {"atom": cw.atomnet_from_flax, "kys": cw.kysnet_from_flax,
              "lwl": cw.lwtlnet_from_flax, "rts50": cw.rtsnet_from_flax,
              "sta": cw.stanet_from_flax, "tomp50": cw.tompnet_from_flax,
              "tomp101": cw.tompnet_from_flax, "tamos_resnet50": cw.tamosnet_from_flax,
              "keep_track_tcm": cw.tcmnet_from_flax}
_DIMP_STEP = "classifier.filter_optimizer.log_step_length"


def _values(net, seed=0):
    """float32 values drawn with numpy at the shapes of `net`'s state_dict."""
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    flat = np.random.default_rng(seed).standard_normal(
        sum(int(np.prod(s)) for s in shapes.values()), dtype=np.float32)
    out, at = {}, 0
    for k, s in shapes.items():
        n = int(np.prod(s))
        out[k] = torch.from_numpy(flat[at:at + n].reshape(s))
        at += n
    return out


def _assert_bitwise(got, ref, label):
    assert set(got) == set(ref), (label, sorted(set(got) ^ set(ref))[:10])
    bad = [k for k in ref if not torch.equal(got[k], ref[k])]
    assert not bad, (label, bad[:10])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loader_matches_jax_porter(family, meta_nets):
    """The upstream dict written from a net's weights (full width) gives
    those weights back through the JAX porter + flax converter and through
    the port's loader, bit for bit, every upstream key consumed by both."""
    make, jax_port, convert, porter = FAMILIES[family]
    net = meta_nets(make)
    ref = _values(net)
    up = writer.upstream_state_dict(porter, ref)
    if family == "super_dimp_simple" and _DIMP_STEP not in up:
        # the JAX porter reads a step length for every DiMP net; the generic
        # Gauss-Newton optimiser has none (the port consumes and drops it)
        up[_DIMP_STEP] = torch.zeros(1)

    jsd = jpw.TrackingStateDict(up)
    variables = jax_port(jsd)
    assert not {k for k in jsd.unconsumed() if not k.endswith(("fc.weight", "fc.bias"))}
    if family == "super_dimp_simple":
        variables["params"]["classifier"]["filter_optimizer"].pop("log_step_length", None)
    via_jax = (convert or CONVERTERS.get(family, cw.dimpnet_from_flax))(variables, net)
    _assert_bitwise(via_jax, ref, f"{family} via JAX")
    del variables, via_jax, jsd

    tsd = pw.TrackingStateDict(up)
    via_port = porter(tsd, net)
    assert not tsd.unconsumed()
    _assert_bitwise(via_port, ref, f"{family} via the port")


def test_missing_and_extra_keys_raise(meta_nets):
    """A dropped upstream key raises naming it, and so does one at another
    shape; an extra one is left unconsumed (the ingest refuses it by name,
    `test_ingest_command_line`). BatchNorm's batch counters and the
    backbone's `fc` do not count as unconsumed."""
    net = meta_nets(_registry_net("atom"))
    up = writer.upstream_state_dict(pw.port_atomnet, _values(net))
    assert "feature_extractor.bn1.num_batches_tracked" in up
    dropped = dict(up)
    del dropped["bb_regressor.fc3_rt.linear.weight"]
    with pytest.raises(KeyError, match=r"bb_regressor\.fc3_rt\.linear\.weight"):
        pw.port_atomnet(dropped, net)
    extra = pw.TrackingStateDict({**up, "bb_regressor.extra.weight": torch.zeros(2),
                                  "feature_extractor.fc.weight": torch.zeros(2, 3),
                                  "feature_extractor.fc.bias": torch.zeros(2)})
    pw.port_atomnet(extra, net)
    assert extra.unconsumed() == {"bb_regressor.extra.weight"}
    reshaped = dict(up)
    reshaped["bb_regressor.iou_predictor.weight"] = torch.zeros(2, 512)
    with pytest.raises(KeyError, match="iou_predictor"):
        pw.port_atomnet(reshaped, net)


FILE_NAMES = ("checkpoint.pth.tar", "{fam}.pth.tar", "{fam}_ep0050.pth.tar", "model.pth",
              "DiMPnet_ep0050.pth.tar", "tomp.pth.tar", "lwl_boxinit.pth.tar")


def _detect(fn, ckpt, path):
    try:
        return fn(ckpt, path)
    except SystemExit:
        return "raises"


def test_detect_family_agrees_with_jax(meta_nets):
    """By net_type, file name and keys, on each family's upstream keys."""
    seen = set()
    for fam, entry in ingest_mod.REGISTRY.items():
        keys = {up: 0 for up, _ in entry[0].layout(list(
            meta_nets(_registry_net(fam)).state_dict())).values()}
        for net_type in (entry[5], None, "DiMPnet"):
            for name in FILE_NAMES:
                path = os.path.join("/data", name.format(fam=fam))
                ckpt = {"net": keys, "net_type": net_type}
                got = _detect(ingest_mod.detect_family, ckpt, path)
                assert got == _detect(jax_ingest.detect_family, ckpt, path), (fam, net_type,
                                                                              name)
                seen.add(got)
    assert set(ingest_mod.REGISTRY) <= seen


def _tiny_net(seed=0):
    net = nn.Sequential(nn.Conv2d(2, 3, 3), BatchNorm(3))
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        for t in net.state_dict().values():
            t.copy_(torch.randn(t.shape, generator=g))
    return net


def test_save_and_load_network(tmp_path):
    """`save_network` / `load_network` round-trip a net bit for bit through
    its sidecar's constructor, with keyword overrides; a sidecar naming the
    JAX package's models is refused before anything is imported."""
    from pytracking_tpu_torch.models.tracking.atomnet import atom_resnet18

    src = atom_resnet18(generator=torch.Generator().manual_seed(5), device="cpu")
    path = str(tmp_path / "nets" / "atom_default.pth")
    save_network(path, src.state_dict(), f"{_M}.tracking.atomnet", "atom_resnet18",
                 {"iou_input_dim": [256, 256]})
    assert sorted(os.listdir(tmp_path / "nets")) == ["atom_default.pth", "atom_default.pth.json"]
    got = load_network(path, device="cpu", iou_inter_dim=(256, 256))
    _assert_bitwise(got.state_dict(), src.state_dict(), "round trip")
    assert not got.training

    with open(path + ".json", "w") as f:
        f.write('{"constructor_module": "pytracking_tpu.models.not_a_module", '
                '"constructor_name": "dimpnet50", "constructor_kwargs": {}}')
    with pytest.raises(ValueError, match="pytracking_tpu_torch.models"):
        load_network(path, device="cpu")


def _save_with_classes(path, obj, classes):
    """torch.save with each class importable under its `__module__` while
    saving only."""
    mods = {}
    for cls in classes:
        parts = cls.__module__.split(".")
        for i in range(1, len(parts) + 1):
            mods.setdefault(".".join(parts[:i]), types.ModuleType(".".join(parts[:i])))
        setattr(mods[cls.__module__], cls.__name__, cls)
    saved = {n: sys.modules.get(n) for n in mods}
    sys.modules.update(mods)
    try:
        torch.save(obj, path)
    finally:
        for n, m in saved.items():
            if m is None:
                del sys.modules[n]
            else:
                sys.modules[n] = m


def test_upstream_checkpoint_reads_with_weights_only(tmp_path):
    """An upstream file with a pickled NetConstructor stand-in (in
    sys.modules only while saving) loads under weights_only=True as data,
    which plain torch.load(weights_only=True) refuses; a file pickling an
    unknown class raises with the class's name."""
    net = _tiny_net(1)
    path = str(tmp_path / "tiny.pth.tar")
    writer.write_upstream_checkpoint(path, pw.port_resnet18_vggm, net.state_dict(), "TinyNet",
                                      fun_name="tiny", fun_module="ltr.models.tiny")
    assert "ltr" not in sys.modules and "ltr.admin.model_constructor" not in sys.modules
    with pytest.raises(pickle.UnpicklingError):
        torch.load(path, map_location="cpu", weights_only=True)
    sd, net_type = read_upstream_checkpoint(path)
    assert net_type == "TinyNet"
    assert sd.pop("1.num_batches_tracked") == 0
    _assert_bitwise(dict(sd), net.state_dict(), "upstream read")

    class Payload:
        def __init__(self):
            self.x = 1
    Payload.__module__, Payload.__qualname__ = "evil.module", "Payload"
    bad = str(tmp_path / "bad.pth.tar")
    _save_with_classes(bad, {"net": net.state_dict(), "net_type": "TinyNet",
                             "settings": Payload()}, [Payload])
    with pytest.raises(pickle.UnpicklingError, match=r"evil\.module\.Payload"):
        read_upstream_checkpoint(bad)


def test_ingest_command_line(tmp_path, monkeypatch):
    """`python -m pytracking_tpu_torch.ingest_checkpoint` on an upstream ATOM
    file (family detected from net_type) writes the network file where
    `parameter/atom/default` finds it, and the module loads those weights;
    an extra key fails the command unless --allow_unconsumed is given."""
    from pytracking_tpu_torch.models.tracking.atomnet import atom_resnet18
    from pytracking_tpu_torch.parameter.atom import default

    src = atom_resnet18(generator=torch.Generator().manual_seed(7), device="cpu").state_dict()
    path = str(tmp_path / "checkpoint.pth.tar")
    writer.write_upstream_checkpoint(path, pw.port_atomnet, src, "ATOMnet")
    net_dir = tmp_path / "networks"
    cmd = [sys.executable, "-m", "pytracking_tpu_torch.ingest_checkpoint", path, "--out_dir",
           str(net_dir)]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert '"family": "atom"' in res.stdout and "atom_default.pth" in res.stdout
    assert sorted(os.listdir(net_dir)) == ["atom_default.pth", "atom_default.pth.json"]
    monkeypatch.setenv("PYTRACKING_TPU_TORCH_NETWORK_PATH", str(net_dir))
    environment.reset_env_settings()
    try:
        got = default.parameters(device="cpu", seed=0).net
    finally:
        environment.reset_env_settings()
    _assert_bitwise(got.state_dict(), src, "atom/default from the ingested file")

    sd, _ = read_upstream_checkpoint(path)
    extra = str(tmp_path / "extra.pth.tar")
    torch.save({"net": {**sd, "bb_regressor.extra.weight": torch.zeros(1)},
                "net_type": "ATOMnet"}, extra)
    with pytest.raises(SystemExit, match=r"bb_regressor\.extra\.weight"):
        ingest_mod.ingest(extra, out_dir=str(tmp_path / "x"))
    assert ingest_mod.ingest(extra, out_dir=str(tmp_path / "y"),
                             allow_unconsumed=True)["family"] == "atom"


# ---------------------------------------------------------- parameter modules

BF16 = torch.bfloat16
# module: ([(network file, the file's constructor, the seeded constructor, seed offset)],
#          bf16 arguments, the load's dtype overrides under them, weights rounded)
PARAM_MODULES = {
    "dimp.dimp50": ([("dimp50", "tracking.dimpnet.dimpnet50", None, 0)],
                    {"dtype": BF16}, {"backbone_dtype": BF16}, True),
    "dimp.dimp18": ([("dimp18", "tracking.dimpnet.dimpnet18", None, 0)], None, None, False),
    "dimp.prdimp18": ([("prdimp18", "tracking.dimpnet.klcedimpnet18", None, 0)],
                      None, None, False),
    "dimp.prdimp50": ([("prdimp50", "tracking.dimpnet.klcedimpnet50", None, 0)],
                      None, None, False),
    "dimp.super_dimp": ([("super_dimp", "tracking.dimpnet.dimpnet50", None, 0)],
                        None, None, False),
    "dimp_simple.super_dimp_simple": (
        [("super_dimp_simple", "tracking.dimpnet.dimpnet50_simple", None, 0)],
        None, None, False),
    "atom.default": ([("atom_default", "tracking.atomnet.atom_resnet18", None, 0)],
                     None, None, False),
    "atom.atom_prob_ml": ([("atom_prob_ml", "tracking.atomnet.atom_resnet18", None, 0)],
                          None, None, False),
    "atom.atom_gmm_sampl": ([("atom_gmm_sampl", "tracking.atomnet.atom_resnet18", None, 0)],
                            None, None, False),
    "kys.default": ([("kys", "tracking.kysnet.kysnet_res50", None, 0)], None, None, False),
    "keep_track.default": (
        [("super_dimp_simple", "tracking.dimpnet.dimpnet50_simple", "dimpnet50", 0),
         ("keep_track_tcm",
          "tcm.target_candidate_matching.target_candidate_matching_net_resnet50", None, 1)],
        None, None, False),
    "lwl.lwl_ytvos": ([("lwl_stage2", "lwl.lwl_net.steepest_descent_resnet50", None, 0)],
                      {"weights_bf16": True}, {}, True),
    "lwl.lwl_boxinit": (
        [("lwl_boxinit", "lwl.lwl_net.steepest_descent_resnet50_boxinit", None, 0)],
        {"weights_bf16": True}, {}, True),
    "rts.rts50": ([("rts50", "rts.rts_net.rts50", None, 0),
                   ("sta", "lwl.sta_net.sta_resnet50", None, 1)],
                  {"weights_bf16": True}, {}, True),
    "tomp.tomp50": ([("tomp50", "tracking.tompnet.tompnet50", None, 0)], {"dtype": BF16},
                    {"backbone_dtype": BF16, "transformer_dtype": BF16}, True),
    "tomp.tomp101": ([("tomp101", "tracking.tompnet.tompnet101", None, 0)], {"dtype": BF16},
                     {"backbone_dtype": BF16, "transformer_dtype": BF16}, True),
    "tamos.tamos_resnet50": ([("tamos_resnet50", "tracking.tamosnet.tamosnet_resnet50",
                               None, 0)], {"dtype": BF16},
                             {"backbone_dtype": BF16, "transformer_dtype": BF16}, False),
    "tamos.tamos_swin_base": ([("tamos_swin_base", "tracking.tamosnet.tamosnet_swin_base",
                                None, 0)], {"dtype": BF16}, {"transformer_dtype": BF16}, False),
}
CONSTRUCTORS = sorted({c.rsplit(".", 1)[1] for nets, *_ in PARAM_MODULES.values()
                       for _, c, _, _ in nets} | {"dimpnet50"})


@pytest.fixture
def tiny_constructors(monkeypatch, tmp_path):
    """Every net constructor the parameter modules reach, in the model
    modules and where a parameter module binds it, replaced by one that
    records its call and returns a tiny net from its generator (seed 0
    without one); the network path an empty directory."""
    calls = []

    def stub(name):
        def ctor(generator=None, device="cuda", **kwargs):
            calls.append((name, None if generator is None else generator.initial_seed(),
                          kwargs))
            return _tiny_net(0 if generator is None else generator.initial_seed()).to(
                resolve_device(device))
        return ctor

    modules = [importlib.import_module(f"{_M}.{m}") for m in INIT_MODULES] + [
        importlib.import_module(f"pytracking_tpu_torch.parameter.{m}") for m in PARAM_MODULES]
    for mod in modules:
        for name in CONSTRUCTORS:
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, stub(name))
    net_dir = tmp_path / "networks"
    net_dir.mkdir()
    monkeypatch.setenv("PYTRACKING_TPU_TORCH_NETWORK_PATH", str(net_dir))
    environment.reset_env_settings()
    yield calls, net_dir
    environment.reset_env_settings()


def _nets(spec, module):
    """The spec's nets in PARAM_MODULES order."""
    if module == "keep_track.default":
        return [spec.net, spec.tracker_kwargs["tcm_net"]]
    if module == "rts.rts50":
        return [spec.net, spec.tracker_kwargs["sta_factory"]()]
    return [spec.net]


@pytest.mark.parametrize("module", list(PARAM_MODULES))
def test_parameter_module_loads_its_network_file(module, tiny_constructors):
    """No file: today's seeded nets. A file (and its sidecar) in the
    network path: its weights, on the asked device; under bf16, the load's
    dtype overrides and the weights rounded after the load where the JAX
    module rounds them. A broken file raises instead of falling back."""
    calls, net_dir = tiny_constructors
    nets, bf16, overrides, rounded = PARAM_MODULES[module]
    mod = importlib.import_module(f"pytracking_tpu_torch.parameter.{module}")

    seeded = _nets(mod.parameters(device="cpu", seed=3), module)
    for (_, file_ctor, seeded_ctor, offset), net in zip(nets, seeded):
        _assert_bitwise(net.state_dict(), _tiny_net(3 + offset).state_dict(), module)
    assert [(c[0], c[1]) for c in calls] == [(seeded_ctor or f.rsplit(".", 1)[1], 3 + o)
                                             for _, f, seeded_ctor, o in nets]

    files = []
    for i, (name, file_ctor, _, _) in enumerate(nets):
        state = _tiny_net(11 + i).state_dict()
        cmod, cname = file_ctor.rsplit(".", 1)
        save_network(str(net_dir / f"{name}.pth"), state, f"{_M}.{cmod}", cname, {})
        files.append(state)
    del calls[:]
    for net, state in zip(_nets(mod.parameters(device="cpu", seed=3), module), files):
        _assert_bitwise(net.state_dict(), state, f"{module} from its file")
    assert [(c[0], c[1]) for c in calls] == [(f.rsplit(".", 1)[1], None)
                                             for _, f, _, _ in nets]

    if bf16 is not None:
        del calls[:]
        got = _nets(mod.parameters(device="cpu", seed=3, **bf16), module)
        assert calls[0][2] == overrides, calls[0]
        want = round_to_bf16_(_tiny_net(11)).state_dict() if rounded else files[0]
        _assert_bitwise(got[0].state_dict(), want, f"{module} bf16")
        if rounded:
            assert not torch.equal(want["0.weight"], files[0]["0.weight"])

    for name, *_ in nets:
        path = net_dir / f"{name}.pth"
        good = path.read_bytes()
        path.write_bytes(b"not a network file")
        del calls[:]
        with pytest.raises(Exception):
            _nets(mod.parameters(device="cpu", seed=3), module)
        assert all(c[1] is None for c in calls), calls       # no seeded fallback
        path.write_bytes(good)
