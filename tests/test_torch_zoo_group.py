"""Port parity, second part (``tests/test_torch_zoo.py`` holds the first
and states the tolerances): the GroupNorm cases of the zoo and the
GroupNorm ResNet in f32, each zoo block in bf16 given flax's input, the
hub's names and ``norm: group``, and the depthwise lane conv."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_zoo import GROUP_NORM_CASES, _assert_flax_layout, check_case

torch.set_num_threads(1)


@pytest.mark.parametrize("case", GROUP_NORM_CASES)
def test_zoo_group_f32_matches_flax(case):
    """As ``test_torch_zoo.test_zoo_f32_matches_flax``, under GroupNorm:
    each gradient leaf in f32 within 1e-4 of its scale."""
    check_case(case)


def _bf16_ulps(got: torch.Tensor, want: np.ndarray) -> np.ndarray:
    a = got.to(torch.float32).numpy()
    b = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return np.abs(a - b) / ulp


def _stage_cases():
    """(id, flax block, port block fn, input channels, spatial)."""
    from fedml_tpu.models import cnn_zoo as fz
    from fedml_tpu.models import resnet as fr
    from fedml_tpu_torch.models import cnn_zoo as tz
    from fedml_tpu_torch.models import resnet as tr

    bf = jnp.bfloat16
    tb = torch.bfloat16

    def ds(norm, stride):
        return (fz.DepthwiseSeparable(64, stride, norm, bf),
                lambda p, st, x: tz._depthwise_separable(p, st, x, stride, norm, tb, True), 32)

    def mb(norm, feats, expand, kernel, stride, se, act, c_in):
        return (fz.MBConv(feats, expand, kernel, stride, se, norm, bf, act),
                lambda p, st, x: tz._mbconv(p, st, x, feats, expand, stride, se, act, norm, tb,
                                            True), c_in)

    return {
        "depthwise_separable-batch": ds("batch", 2),
        "depthwise_separable-group": ds("group", 1),
        "mbconv_hswish_se-batch": mb("batch", 40, 3, 5, 2, True, "hswish", 24),
        "mbconv_relu-batch": mb("batch", 24, 3, 3, 1, False, "relu", 24),
        "mbconv_swish_se_residual-batch": mb("batch", 40, 6, 5, 1, True, "swish", 40),
        "mbconv_swish_se-group": mb("group", 24, 1, 3, 1, True, "swish", 32),
        "basic_block-group": (fr.BasicBlock(32, 2, "group", bf),
                              lambda p, st, x: tr.basic_block(p, st, x, 2, 32, True, tb, "group"),
                              16),
    }


@pytest.mark.parametrize("case", sorted(_stage_cases()))
def test_bf16_stage_matches_flax(case):
    """One block in bf16, given flax's bf16 input: each element within one
    bf16 ulp of flax's (``|a - b| <= 2^(e - 7)``, ``e`` the exponent of
    the larger magnitude), or, where the block's last add or BN cancels
    to a small value, within 8 bf16 ulps at the output's RMS.  Measured on
    the CPU: four blocks bitwise, the rest one ulp, except the residual
    MBConv (2.5% of elements past one ulp, all within 4 ulps at the RMS)
    and the plain MBConv (0.03%, within 2)."""
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt

    ref_block, port_block, c_in = _stage_cases()[case]
    x = jnp.asarray(np.random.RandomState(3).randn(8, 8, 8, c_in), jnp.bfloat16)
    shapes = jax.eval_shape(lambda: ref_block.init(jax.random.PRNGKey(0), x, train=False))
    rs = np.random.RandomState(4)
    fv = jax.tree_util.tree_map(
        lambda s: (rs.randn(*s.shape) * (0.1 if len(s.shape) == 1 else 0.3)
                   + (1.0 if len(s.shape) == 1 else 0.0)).astype(np.float32), shapes)
    mut = [k for k in fv if k != "params"]
    want = ref_block.apply(fv, x, train=True, mutable=mut or False)
    want = want[0] if mut else want
    assert want.dtype == jnp.bfloat16
    tv = pt.tree_map(lambda t: t[None], weights.to_torch(weights.flax_to_torch(fv)))
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)[None]
    got, _ = port_block(tv["params"], tv.get("batch_stats", {}), xt)
    assert got.dtype == torch.bfloat16 and got.shape[1:] == want.shape
    want = np.asarray(want.astype(jnp.float32))
    ulps = _bf16_ulps(got[0], want)
    rms_ulp = np.exp2(np.floor(np.log2(np.sqrt(np.mean(want ** 2)))) - 7)
    off = np.abs(got[0].to(torch.float32).numpy() - want) / rms_ulp
    assert np.all((ulps <= 1) | (off <= 8)), (ulps.max(), off.max())


@pytest.mark.parametrize("name,norm", [("mobilenet", "batch"), ("mobilenet", "group"),
                                       ("mobilenet_v3", "batch"), ("mobilenetv3", "group"),
                                       ("efficientnet", "batch"), ("efficientnet_b0", "group"),
                                       ("vgg11", "batch"), ("vgg", "group"), ("vgg16", "batch"),
                                       ("resnet18_gn", "batch"), ("resnet_gn", "batch"),
                                       ("resnet20", "group")])
def test_hub_creates_the_zoo(name, norm):
    """Every zoo name and ``norm: group`` through both hubs: the flax
    tree's names and shapes, the parameter count, the stem from the
    dataset's spec (CIFAR's stride 1, ILSVRC's stride 2), the compute
    dtype."""
    from fedml_tpu.arguments import Config as RefConfig
    from fedml_tpu.models import model_hub as ref_hub
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.models import model_hub

    for dataset, shape in (("cifar10", (1, 32, 32, 3)), ("imagenet", (1, 64, 64, 3))):
        kw = dict(model=name, dataset=dataset, norm=norm, compute_dtype="bfloat16")
        ref_model = ref_hub.create(RefConfig(**kw), 10)
        model = model_hub.create(Config(**kw), 10, input_shape=shape[1:])
        variables = model.init(torch.Generator().manual_seed(0))
        _assert_flax_layout(ref_model, np.zeros(shape, np.float32), variables)
        assert model.dtype == torch.bfloat16
        if hasattr(model, "small_input") and hasattr(ref_model, "small_input"):
            assert model.small_input == ref_model.small_input == (dataset == "cifar10")
        if name == "resnet20":
            assert model.norm == "group" and not model.fused_path
    counts = {"mobilenet": 3217226, "mobilenet_v3": 1103900, "efficientnet": 7155658,
              "vgg11": 9491018, "vgg16": 14986698}
    if name in counts and norm == "batch":
        n = sum(t.numel() for t in pt.tree_leaves(variables["params"]))
        assert n == counts[name]


def test_depthwise_conv_lanes_and_groups():
    """``conv2d_lanes`` with a feature-group count: ``L * C`` groups for a
    depthwise conv, each lane what the conv gives it alone (one lane), and
    that against flax's ``feature_group_count`` (stride 2, odd size: flax's
    asymmetric SAME padding)."""
    from flax import linen as nn
    from fedml_tpu_torch.models.resnet import conv2d_lanes

    rs = np.random.RandomState(5)
    x = rs.randn(3, 2, 7, 7, 12).astype(np.float32)
    k = rs.randn(3, 12, 1, 5, 5).astype(np.float32)
    got = conv2d_lanes(torch.from_numpy(x), torch.from_numpy(k), 2, torch.float32, groups=12)
    assert got.shape == (3, 2, 4, 4, 12)
    for lane in range(3):
        alone = conv2d_lanes(torch.from_numpy(x[lane:lane + 1]), torch.from_numpy(k[lane:lane + 1]),
                             2, torch.float32, groups=12)[0]
        np.testing.assert_allclose(got[lane].numpy(), alone.numpy(), atol=1e-6, rtol=0)
        conv = nn.Conv(12, (5, 5), strides=2, padding="SAME", feature_group_count=12,
                       use_bias=False)
        want = conv.apply({"params": {"kernel": k[lane].transpose(2, 3, 1, 0)}}, x[lane])
        np.testing.assert_allclose(alone.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["cnn_femnist", "char_lstm", "word_lstm", "mobilenet_group",
                                  "mobilenet_v3_batch", "resnet20_group"])
def test_weights_carry_and_flatten_reference(name):
    """The carry rules on every new leaf kind (the LSTM gate kernels
    transposed as Dense kernels, ``Embed_0/embedding`` as it is, depthwise
    kernels ``(C, 1, kh, kw)`` <-> flax ``(kh, kw, 1, C)``, GroupNorm's
    ``scale`` / ``bias``): the port's tree to flax and back bitwise, and
    ``weights.flatten_reference`` bitwise the reference's
    ``tree_flatten_to_vector`` of the flax tree (the FedAvg CNN on FEMNIST:
    1,690,046 elements, the vector qsgd_int8 blocks), its ``unravel`` the
    inverse."""
    from fedml_tpu.core import pytree as ref_pt
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.models import cnn_zoo, resnet, rnn, simple

    model = {"cnn_femnist": simple.FedAvgCNN(62, False, (28, 28, 1)),
             "char_lstm": rnn.CharLSTM(), "word_lstm": rnn.WordLSTM(600),
             "mobilenet_group": cnn_zoo.MobileNetV1(10, norm="group"),
             "mobilenet_v3_batch": cnn_zoo.MobileNetV3Small(10),
             "resnet20_group": resnet.resnet20(10, norm="group")}[name]
    variables = model.init(torch.Generator().manual_seed(0))
    params = variables["params"]
    flax_params = weights.torch_to_flax(weights.to_numpy(params))
    back = weights.flax_to_torch(flax_params)
    for a, b in zip(pt.tree_leaves(params), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a.numpy(), b)
    if "lstm" in name:
        cell = flax_params["StackedLSTM_0"]["OptimizedLSTMCell_0"]
        assert cell["ii"]["kernel"].shape == (model.embed_dim, model.hidden)
        assert flax_params["Embed_0"]["embedding"].shape == (model.vocab_size, model.embed_dim)
    if name == "mobilenet_group":
        dw = flax_params["DepthwiseSeparable_0"]["Conv_0"]["kernel"]
        assert dw.shape == (3, 3, 1, 32)
        np.testing.assert_array_equal(
            dw[1, 2, 0], params["DepthwiseSeparable_0"]["Conv_0"]["kernel"][:, 0, 1, 2].numpy())
    flat, unravel = weights.flatten_reference(params)
    want, _ = ref_pt.tree_flatten_to_vector(flax_params)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    if name == "cnn_femnist":
        assert flat.numel() == 1690046
    for a, b in zip(pt.tree_leaves(unravel(flat)), pt.tree_leaves(params)):
        assert torch.equal(a, b)
