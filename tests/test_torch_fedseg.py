"""Port parity: FedSeg (``fedml_tpu_torch/sim/fedseg.py``,
``models/segmentation.py``) against the JAX package.

- flax's ``ConvTranspose`` (2x2, stride 2, ``SAME``, no kernel flip) with
  an asymmetric kernel and a bias, lanes of 2, against the port's
  ``conv_transpose_lanes`` within 1e-6; the UNet (base 4, 3 classes)
  from random weights within 1e-5 of the output's scale.
- ``segmentation_metrics`` on random logits and labels (one class absent
  from the labels): the confusion matrix equal to numpy's, the three
  metrics within 1e-6 relative of the reference's.
- ``synthesize_masks`` bitwise.
- FedSeg 2 rounds on ``mnist`` (synthesized masks) and on ``fets2021`` (the
  stand-in's masks; 4 clients, 2 a round as lanes, batch 4, 2 steps,
  ``seg_base`` 4, f32), the reference's sampled ids and batch rows
  injected and its initial weights copied: the global UNet within 1e-5
  relative L2 over its movement (measured 1.1e-6), the loss within 1e-5
  relative, the test metrics within 1e-4 absolute.
- Non-image data (``synthetic``) refused in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_split_learning import JaxOwnSampler, _cfgs, _datasets, flat, port_vars, ref_flat

torch.set_num_threads(1)

TOL = 1e-5


def test_conv_transpose_with_an_asymmetric_kernel():
    from flax import linen as nn
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.models.segmentation import conv_transpose_lanes

    rs = np.random.RandomState(0)
    layer = nn.ConvTranspose(3, (2, 2), strides=(2, 2))
    xs = rs.randn(2, 2, 3, 5, 4).astype(np.float32)
    lanes = []
    for lane in range(2):
        kernel = rs.randn(2, 2, 4, 3).astype(np.float32)
        kernel[0, 1] += 3.0  # no symmetry in either spatial axis
        v = {"params": {"kernel": jnp.asarray(kernel),
                        "bias": jnp.asarray(rs.randn(3).astype(np.float32))}}
        want = np.asarray(layer.apply(v, jnp.asarray(xs[lane])))
        lanes.append((port_vars(v)["params"], want))
    got = conv_transpose_lanes(pt.tree_stack([p for p, _ in lanes]), torch.from_numpy(xs))
    assert tuple(got.shape) == (2, 2, 6, 10, 3)
    for lane, (_, want) in enumerate(lanes):
        np.testing.assert_allclose(got[lane].numpy(), want, rtol=1e-6, atol=1e-6)


def test_unet_forward_matches_flax():
    from fedml_tpu.models.segmentation import UNet as Ref
    from fedml_tpu_torch.models.segmentation import UNet

    rs = np.random.RandomState(1)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    ref = Ref(num_classes=3, base=4)
    v = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(rs.randn(*a.shape).astype(np.float32) * 0.5), v)
    want = np.asarray(ref.apply(v, jnp.asarray(x)))
    got, _ = UNet(3, 4, 4).apply(port_vars(v), torch.from_numpy(x))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_segmentation_metrics_match_the_reference():
    from fedml_tpu.models.segmentation import segmentation_metrics as ref_metrics
    from fedml_tpu_torch.models.segmentation import confusion_matrix, segmentation_metrics

    rs = np.random.RandomState(2)
    logits = rs.randn(3, 9, 7, 5).astype(np.float32)
    labels = rs.randint(0, 4, (3, 9, 7)).astype(np.int32)  # class 4 never a label
    preds = logits.argmax(-1)
    want_conf = np.zeros((5, 5), np.float32)
    np.add.at(want_conf, (labels.ravel(), preds.ravel()), 1.0)
    conf = confusion_matrix(torch.from_numpy(preds), torch.from_numpy(labels), 5)
    np.testing.assert_array_equal(conf.numpy(), want_conf)
    got = segmentation_metrics(torch.from_numpy(logits), torch.from_numpy(labels), 5)
    want = ref_metrics(jnp.asarray(logits), jnp.asarray(labels), 5)
    for k in ("pixel_acc", "miou", "fwiou"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


def test_synthesize_masks_bitwise():
    from fedml_tpu.sim.fedseg import synthesize_masks as ref_masks
    from fedml_tpu_torch.sim.fedseg import synthesize_masks

    rs = np.random.RandomState(3)
    x = rs.randn(13, 10, 6, 1).astype(np.float32)
    y = rs.randint(0, 10, 13)
    for classes in (3, 10):
        got = synthesize_masks(x, y, classes, seed=4)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref_masks(x, y, classes, seed=4))


@pytest.mark.parametrize("dataset", ["mnist", "fets2021"])
def test_two_rounds_match_the_reference(tmp_path, dataset):
    from fedml_tpu.sim.fedseg import FedSegSimulator as Ref
    from fedml_tpu_torch.sim.fedseg import FedSegSimulator

    ref_cfg, cfg = _cfgs(tmp_path, "FedSeg", dataset=dataset, client_num_per_round=2,
                         batch_size=4, synthetic_train_size=32, synthetic_test_size=12,
                         extra={"seg_base": 4})
    ref_ds, ds = _datasets(ref_cfg, cfg)
    ref = Ref(ref_cfg, ref_ds)
    sim = FedSegSimulator(cfg, ds, device="cpu", sampler=JaxOwnSampler(ref.root_key, 4, 2))
    np.testing.assert_array_equal(sim._m.numpy(), np.asarray(ref._m))
    np.testing.assert_array_equal(sim._test[1].numpy(), np.asarray(ref._test[1]))
    assert sim.steps == 2 and sim.num_classes == ref.num_classes
    sim.variables = port_vars(ref.variables)
    start = ref_flat(ref.variables)
    for _ in range(2):
        want_m, got_m = ref.run_round(), sim.run_round()
        np.testing.assert_allclose(got_m["train_loss"], want_m["train_loss"], rtol=TOL)
    want = ref_flat(ref.variables)
    assert np.abs(want - start).max() > 1e-4
    assert np.linalg.norm(flat(sim.variables) - want) <= TOL * np.linalg.norm(want - start)
    want_e = {k: float(v) for k, v in ref._eval(ref.variables).items()}
    got_e = sim.evaluate()
    for k in ("pixel_acc", "miou", "fwiou"):
        np.testing.assert_allclose(got_e[k], want_e[k], atol=1e-4)


def test_non_image_data_refused_in_both_packages(tmp_path):
    """FedSeg needs ``(H, W, C)`` samples: ``synthetic``'s 60 features fail
    the reference's assert and the port's ``ValueError``, with the same
    words."""
    from fedml_tpu.sim.fedseg import FedSegSimulator as Ref
    from fedml_tpu_torch.sim.fedseg import FedSegSimulator

    ref_cfg, cfg = _cfgs(tmp_path, "FedSeg", dataset="synthetic", extra={"seg_base": 4})
    ref_ds, ds = _datasets(ref_cfg, cfg)
    with pytest.raises(AssertionError, match=r"FedSeg needs \(H, W, C\) image data"):
        Ref(ref_cfg, ref_ds)
    with pytest.raises(ValueError, match=r"FedSeg needs \(H, W, C\) image data"):
        FedSegSimulator(cfg, ds, device="cpu")
