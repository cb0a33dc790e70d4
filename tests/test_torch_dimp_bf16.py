"""The bf16 backbone options of the port's DiMP-50 and ECO against the JAX
package's switches, on the CPU.

`parameter/dimp/dimp50.parameters(dtype=torch.bfloat16)` is the counterpart
of PYTRACKING_TPU_BF16=1 (a bf16 ResNet-50, every float weight stored as
bf16 by `maybe_bf16_variables`), `backbone_dtype=torch.bfloat16` of
PYTRACKING_TPU_BF16_BACKBONE=1; ECO's `parameter/eco/default.parameters
(backbone_dtype=torch.bfloat16)` of either (a bf16 ResNet18-VGG-m1 with
float32 weights). Each bf16 stage is held to the JAX bf16 stage on the JAX
stage's own input: where both round alike they agree to float32 rounding,
and a rounding that falls the other way moves an element by one bf16 ulp
of its own magnitude (measured on these inputs: at most 0.061% of a
stage's elements differ by more than 1e-5 of its scale, the largest
difference half a bf16 ulp of the stage's largest magnitude; the check
allows 2% and one ulp). Over a whole backbone the
one-ulp differences compound, so the stages are held one by one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytracking_tpu_torch.models.backbones import vggm_resnet as t_vggm
from pytracking_tpu_torch.models.layers.blocks import BatchNorm
from pytracking_tpu_torch.parameter.dimp import dimp50 as t_dimp50
from pytracking_tpu_torch.parameter.eco import default as t_eco_default
from pytracking_tpu_torch.utils.convert_weights import dimpnet_from_flax, eco_backbone_from_flax
from pytracking_tpu_torch.utils.loading import round_to_bf16_
from test_torch_lwl_ops import one_thread  # noqa: F401 (autouse: one CPU thread)
from test_torch_dimp import _perturb_batch_stats


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def _within_one_rounding(got, ref, name):
    """At most 2% of the elements differ by more than 1e-5 of the output's
    scale, and none by more than one bf16 ulp of it."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert got.shape == ref.shape, name
    assert np.mean(np.abs(got - ref) > 1e-5 * np.abs(ref).max()) <= 0.02, name
    assert np.abs(got - ref).max() <= _bf16_ulp(ref), name


def _f32_numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _nchw16(x):
    return torch.from_numpy(np.moveaxis(np.array(x, np.float32), -1, 1)).to(torch.bfloat16)


def _nhwc(x):
    return np.moveaxis(x.float().numpy(), 1, -1)


def _normalized_image(seed, s=64):
    im = np.random.RandomState(seed).rand(2, s, s, 3).astype(np.float32) * 255
    from pytracking_tpu.models.backbones.resnet import normalize_image
    return np.asarray(normalize_image(jnp.asarray(im)))


def _exact_bf16(fn, *args):
    """fn(*args) jitted with XLA's excess precision off: by default XLA keeps
    some bf16 intermediates of a fused chain in float32 (here the LRN's),
    which no bf16 op-by-op computation reproduces."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _blocks(inter, names):
    return {n: np.asarray(inter[n]["__call__"][0], np.float32) for n in names}


def _hold_blocks(t_fe, inter, names, first_input):
    """Each port block on the JAX block's input against the JAX block."""
    outs = _blocks(inter, names)
    prev = first_input
    with torch.inference_mode():
        for n in names:
            got = getattr(t_fe, n)(prev if isinstance(prev, torch.Tensor) else _nchw16(prev))
            _within_one_rounding(_nhwc(got), outs[n], n)
            prev = outs[n]


# ---------------------------------------------------------------- DiMP-50

@pytest.fixture(scope="module")
def r50():
    """(JAX bf16 ResNet-50 also returning its stem, maybe_bf16_variables of
    its perturbed float32 init, those float32 variables)."""
    from pytracking_tpu.models.backbones.resnet import resnet50
    from pytracking_tpu.utils.loading import maybe_bf16_variables

    jnet = resnet50(output_layers=("conv1", "layer2", "layer3"), dtype=jnp.bfloat16)
    v32 = jax.jit(lambda k: jnet.init(k, jnp.zeros((1, 64, 64, 3))))(jax.random.PRNGKey(0))
    v32 = _perturb_batch_stats(_f32_numpy(dict(v32)), 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTRACKING_TPU_BF16", "1")
        v16 = maybe_bf16_variables(v32)
    return jnet, v16, v32


def test_dimp50_dtype_rounds_every_weight():
    """dtype=bf16: every float weight of the net is the float32 net's
    rounded through bf16 and every BatchNorm computes on bf16 statistics;
    backbone_dtype=bf16 alone leaves the weights as they are. Both run the
    backbone's convolutions in bf16."""
    sd32 = t_dimp50.parameters(device="cpu", seed=1).net.state_dict()
    net16 = t_dimp50.parameters(device="cpu", seed=1, dtype=torch.bfloat16).net
    for k, v in net16.state_dict().items():
        ref = sd32[k].to(torch.bfloat16).float() if v.is_floating_point() else sd32[k]
        assert torch.equal(v, ref), k
    assert all(m.param_dtype == torch.bfloat16 for m in net16.modules()
               if isinstance(m, BatchNorm))
    bb = t_dimp50.parameters(device="cpu", seed=1, backbone_dtype=torch.bfloat16).net
    for k, v in bb.state_dict().items():
        assert torch.equal(v, sd32[k]), k
    for net in (net16, bb):
        assert net.feature_extractor.dtype == torch.bfloat16
        assert net.feature_extractor.conv1.compute_dtype == torch.bfloat16


def test_round_to_bf16_matches_maybe_bf16_variables(r50):
    """torch's bf16 rounding of the backbone's weights equals
    maybe_bf16_variables' (both round to nearest even)."""
    _, v16, v32 = r50
    fe = t_dimp50.parameters(device="cpu", seed=0, dtype=torch.bfloat16).net.feature_extractor
    fe.load_state_dict(dimpnet_from_flax(v32, fe))
    round_to_bf16_(fe)
    ref = dimpnet_from_flax(_f32_numpy(v16), fe)
    for k, v in fe.state_dict().items():
        assert torch.equal(v, ref[k]), k


def test_dimp50_bf16_backbone_blocks_match_jax(r50):
    """PYTRACKING_TPU_BF16's ResNet-50 stage by stage: the stem (bf16 conv,
    BatchNorm in bf16 arithmetic on bf16 statistics) and the 13 bottleneck
    blocks to layer3, each on the JAX stage's input."""
    jnet, v16, _ = r50
    net = t_dimp50.parameters(device="cpu", seed=0, dtype=torch.bfloat16).net
    fe = net.feature_extractor
    fe.load_state_dict(dimpnet_from_flax(_f32_numpy(v16), fe))
    x = _normalized_image(5)
    out, inter = _exact_bf16(lambda v, x: jnet.apply(v, x, capture_intermediates=True,
                                                     mutable=["intermediates"]), v16, x)
    inter = inter["intermediates"]
    with torch.inference_mode():
        stem = F.relu(fe.bn1(fe.conv1(_nchw16(x))))
    _within_one_rounding(_nhwc(stem), out["conv1"], "stem")
    pooled = F.max_pool2d(_nchw16(out["conv1"]), 3, stride=2, padding=1)
    names = [f"layer{s + 1}_{b}" for s, n in enumerate((3, 4, 6)) for b in range(n)]
    _hold_blocks(fe, inter, names, pooled)


# ---------------------------------------------------------------- ECO

def test_eco_bf16_backbone_blocks_match_jax():
    """ECO's backbone_dtype=bf16 (float32 weights): vggconv1 (bf16 conv,
    ReLU and the LRN in bf16 arithmetic), the stem and the six BasicBlocks
    to layer3, each on the JAX stage's input; the wrapper's outputs are
    float32."""
    from pytracking_tpu.models.backbones.vggm_resnet import resnet18_vggmconv1
    from pytracking_tpu.parameter.eco.default import _ECOBackbone

    jnet = _ECOBackbone(resnet18_vggmconv1(("vggconv1", "conv1", "layer3"),
                                           dtype=jnp.bfloat16))
    v32 = jax.jit(lambda k: jnet.init(k, jnp.zeros((1, 64, 64, 3))))(jax.random.PRNGKey(1))
    v32 = _perturb_batch_stats(_f32_numpy(dict(v32)), 4)
    spec = t_eco_default.parameters(device="cpu", seed=0, backbone_dtype=torch.bfloat16)
    assert spec.net.feature_extractor.dtype == torch.bfloat16
    # the module's net with the stem as an output too (the same weights)
    net = t_eco_default.eco_backbone(
        t_vggm.resnet18_vggmconv1(("vggconv1", "conv1", "layer3"), dtype=torch.bfloat16),
        device="cpu")
    net.load_state_dict(eco_backbone_from_flax(v32, net))
    fe = net.feature_extractor
    im = np.random.RandomState(6).rand(2, 64, 64, 3).astype(np.float32) * 255
    out, inter = _exact_bf16(lambda v, x: jnet.apply(
        v, x, method=lambda m, x: m.extract_backbone(x), capture_intermediates=True,
        mutable=["intermediates"]), v32, im)
    inter = inter["intermediates"]["feature_extractor"]
    with torch.inference_mode():
        got = net.extract_backbone(torch.from_numpy(np.moveaxis(im, -1, 1)).contiguous())
    assert all(v.dtype == torch.float32 for v in got.values())
    _within_one_rounding(_nhwc(got["vggconv1"]), out["vggconv1"], "vggconv1")
    _within_one_rounding(_nhwc(got["conv1"]), out["conv1"], "conv1")
    pooled = F.max_pool2d(_nchw16(out["conv1"]), 3, stride=2, padding=1)
    names = [f"layer{s + 1}_{b}" for s in range(3) for b in range(2)]
    _hold_blocks(fe, inter, names, pooled)
